#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kmergma_tpu_torch/csrc`` (into
``build/kmergma_tpu_torch/``) and drives every path of the port:

* single profile: K1 (K3's kernel at one profile, also per stage) and
  K2 (on the planned region rows and on the whole-record scan's
  overlapping rows, with its device time beside the wrapper's) against
  their plain PyTorch twins on the card at the main path's shapes
  (bit-identical: the scan is integer arithmetic), the golden hits through ``kmergma_tpu_torch.find_genes``,
  then a 64 Mbp synthetic genome (four 16 Mbp contigs of hashed background
  with the 84 Alp_V reference genes planted every 500 kb) mined against the
  int64 host oracle, and where one call's wall goes: each stage timed
  alone, and the device's busy share of one profiled call;
* cluster mode (the Alp_V set in six clusters): K3, K8 and K5 against
  their twins (K3 also per stage with its grid, and on the ``__ldg`` route
  over the same contig at k = 7; K8's device time from torch.profiler and
  from calls queued behind a spin, beside ``index_select``'s), the cluster
  goldens through ``find_genes_cluster_mode``
  (the split route, so K5), both routes on one record, then the same
  genome plus one short contig (the split route again) mined against an
  int64 host cluster oracle, and where one call's wall goes; K5 with its
  device time and launch shape on 60 kb, 16 kb and 4 Mbp records; then a
  fragmented assembly (1,024 records of 16 kb, 16.4 Mbp, each on the
  split route) through ``ClusterScanEngine.record_streams``, the first 64
  records against the int64 host cluster oracle, and one 16 kb and one
  60 kb bitmap pass on both routes: K5's device time against the torch
  glue after it, and K3's route on the same record;
* strobemers (the Alp_V strobe profile, s 2, w_min 3, w_max 5, q 5): K4r
  (K4 at depth ws - k = 282 over uint8 strobe codes, codes >= 128 present:
  the sliding-histogram route) against its twin, and its depth-loop route
  on int32 strobe codes at s = 3, the strobe goldens through ``strobemer_find_genes``,
  then the same genome mined against an int64 host oracle of the strobe
  recurrence, and where one call's wall goes;
* checkpoint/resume: each of the three miners, with ``checkpoint_path=``,
  killed on its third record of the genome its phase mined (an engine
  that raises ``KeyboardInterrupt``), then resumed on the card with its
  default engine: the hits, sequences and loci of that phase's
  uninterrupted API call, only the records left scanned, the path's
  kernels launched, the file removed; then ``find_genes`` resumes a killed
  run through the API.  Each kill's and resume's wall and the file's size;
* the paired k-mer spectrum (``kmer_pair_count_device``, k = 3, torch
  histograms) of one 16 Mbp contig on the card against the CPU, a 4 kb
  slice against the O(n^2) host loop, and its time a call;
* a mixed-depth cluster set (the six Alp_V clusters plus a profile of the
  genes' 20 bp prefixes, ws 20, pair depth 14): K4 and K6 against their
  twins, each at both of its depths with its device time, then ``ClusterScanEngine`` on one 16 Mbp contig and the short
  contig, its streams equal to an int64 host cluster oracle's;
* the port's throughput harness (``kmergma_tpu_torch.bench.run``) at its
  default sizes, every genome made on the card by K7 (a 512 Mbp headline,
  64 Mbp hit-dense, k = 10 and strobe genomes, 6 x 512 Mbp records), each
  row then held against an independent reference at its own size: K7
  against its twin over the whole headline genome, K1 against its twin on
  the headline (in 64 Mbp pieces), dense and k = 10 genomes and K3 on the
  dense genome; the headline, k = 10 and 3.2 Gbp rows against the int64
  host engine over each whole record, the dense row's hits against
  ``mine_genome`` on it, the cluster streams against the int64 host
  cluster oracle and the strobe hits against the int64 host strobe
  oracle; with the 3.2 Gbp row's peak device memory and the device's busy
  share of one headline and one hit-dense row.

Each path's kernels are shown to have launched in that path's run: their
launch counts are set to 0 just before it and read just after.  Kernel
times are CUDA events over back-to-back launches after a warm-up, the
median of five windows with the fastest beside it.

``python3 chip_smoke.py --pair-kernels`` times K2, K4, K6 and K5 alone
at those shapes (one JSON line); a copy of this file placed in the root of
an earlier checkout times that checkout's kernels the same way.  It is
the parent-against-change tool of the pair kernels' redesigns and takes
no other option.

It imports only the port (``kmergma_tpu_torch``), never jax or the JAX
package.  Exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.  Its last line is
``{"ok": true, "device": {...}}``; before it the kernels' JSON and the
card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
REF = str(DATA / "Alp_V_ref.fasta")

GOLDEN_LOCUS = [
    "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
    "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
    "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
]
GOLDEN_LOCI = [8543, 20425, 221912, 234018, 450875, 467930, 477868]
GOLDEN_CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
GOLDEN_CLUSTER = [
    "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
    "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
    "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
]
#: the JAX package's ``strobemer_find_genes`` on Alp_V_locus with its
#: defaults, taken on the CPU (tests/test_torch_strobe.py holds the port to
#: the JAX package itself)
GOLDEN_STROBE = [
    "AM773548.1 | dist = 7.94 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
    "AM773548.1 | dist = 23.82 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
    "AM773548.1 | dist = 7.82 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
]
#: the cluster path's extra contig: shorter than K3's cutover of 65,536
#: windows, so it takes the split route (K5)
SHORT_CONTIG_BP = 60_000
#: the fragmented assembly: FRAGMENTS records of FRAGMENT_BP each, cut
#: from the synthetic genome (16.4 Mbp), all on the split route (K5)
FRAGMENT_BP = 16_000
FRAGMENTS = 1_024
#: of which the first ORACLE_FRAGMENTS are held against the int64 host oracle
ORACLE_FRAGMENTS = 64
#: the mixed-depth set's extra profile: the reference genes' prefixes
PREFIX_BP = 20
#: the checkpoint phase kills each run on this record (counting from 0)
KILL_AT = 2
#: the paired spectrum's slice held against the O(n^2) host loop
PAIRED_SLICE_BP = 4_000
#: the bench phase's row sizes, the harness's defaults: a 512 Mbp headline,
#: 64 Mbp hit-dense, k = 10 and strobe genomes, and 6 x 512 Mbp records
BENCH_SIZES = {"n_mbp": 512.0, "dense_mbp": 64.0, "k10_mbp": 64.0, "strobe_mbp": 64.0, "g3_mbp": 3200.0}

#: one H100 SXM's published peaks (NVIDIA's data sheet): device memory
#: bytes per second,
#: and the non-tensor 32-bit rate, taken as the ceiling of the kernels'
#: 32-bit integer compares and adds
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
#: integer operations a position of K4r's sliding histogram does: two bin
#: reads, two bin updates, the subtraction and the K code
HIST_OPS_PER_POSITION = 6
#: integer operations a profile adds to each window of a bitmap pass (K1,
#: K3) beside the shared pair tests: two products, two subtractions, the
#: delta's add, the prefix sum's add and the threshold compare
PROFILE_OPS_PER_WINDOW = 7


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def hash_codes(n: int, offset: int, seed: int = 0):
    """2-bit codes from a splitmix-style hash of the position (the JAX
    bench's synthetic genome, bench.py hash_codes)."""
    import numpy as np

    x = np.arange(offset, offset + n, dtype=np.uint32) * np.uint32(0x9E3779B9) + np.uint32(seed)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return ((x >> np.uint32(7)) & np.uint32(3)).astype(np.int8)


def synthetic_genome(n_contigs: int, contig_bp: int, plant_every: int, genes) -> list:
    """Hashed background (seed 0) with the reference genes planted every
    ``plant_every`` bp, cycling through them; returns one code array per
    contig."""
    contigs = []
    plant = 0
    for ci in range(n_contigs):
        codes = hash_codes(contig_bp, ci * contig_bp)
        for pos in range(plant_every // 2, contig_bp - plant_every // 2 + 1, plant_every):
            gene = genes[plant % len(genes)]
            codes[pos : pos + gene.shape[0]] = gene
            plant += 1
        contigs.append(codes)
    return contigs


def write_fasta(path: Path, contigs) -> None:
    import numpy as np

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as fh:
        for ci, codes in enumerate(contigs):
            fh.write(f">contig{ci}\n".encode())
            seq = letters[codes]
            width = 80
            full = seq.shape[0] // width * width
            lines = np.concatenate(
                [seq[:full].reshape(-1, width), np.full((full // width, 1), ord("\n"), np.uint8)], axis=1
            )
            fh.write(lines.tobytes())
            if full < seq.shape[0]:
                fh.write(seq[full:].tobytes() + b"\n")


class HostClusterOracle:
    """The exact int64 host oracle of cluster mode: one ``HostScanEngine``
    per cluster, full streams (``mine_genome_clusters(engine=...)``)."""

    def __init__(self, profiles, k: int):
        from kmergma_tpu_torch.ops.scan_host import HostScanEngine

        self.k = k
        self.engines = [HostScanEngine(p.sum_kfv, k=k, ws=p.windowsize, r=p.n_records) for p in profiles]

    def record_streams(self, codes, thrs):
        return [e.record_stream(codes, thr)[:2] for e, thr in zip(self.engines, thrs)]

    def minimal_streams(self, codes, thrs, max_ws: int) -> list:
        """Each cluster's (dist0, minimal stream) cut at the cluster loop's
        bound, the contract of ``ClusterScanEngine.record_streams``."""
        n = codes.shape[0]
        imax = n - max_ws - self.k + 2
        out = []
        for e, x in zip(self.engines, thrs):
            d = e._dists(codes)
            out.append((float(d[0]) / e.scale, minimal_stream(d, e.scale, x, min(n - e.ws, imax))))
        return out


def minimal_stream(d, scale: float, thr: float, mi: int) -> list:
    """The cluster engine's run-reduced stream from a cluster's full int64
    distances ``d``: for each maximal run of windows 1..mi with d / scale <
    thr, its first argmin and the window after it when that is <= mi."""
    import numpy as np

    d = d[: mi + 1]
    below = d / scale < thr
    below[0] = False
    idx = np.flatnonzero(below)
    if idx.size == 0:
        return []
    cut = np.flatnonzero(np.diff(idx) > 1)
    out = []
    for lo, hi in zip(np.r_[idx[0], idx[cut + 1]], np.r_[idx[cut], idx[-1]]):
        j = int(lo + np.argmin(d[lo : hi + 1]))
        out.append((j, float(d[j]) / scale))
        if hi + 1 <= mi:
            out.append((int(hi + 1), float(d[hi + 1]) / scale))
    return sorted(out)


def strobe_distances_i64(sc, s_sum, w: int, r: int):
    """Exact int64 scaled distances of the StrobeGMA recurrence over strobe
    codes ``sc`` (its n_steps + w leading codes), in the closed form of
    ``ops/scan_strobe.py``: the unmodified profile, width-w window counts
    plus the x* = sc[w] correction.  The counts of a code among positions
    [p, p + w) are read off the sorted (code, position) keys: a position's
    own rank, and one binary search of sorted queries."""
    import numpy as np

    K = np.asarray(sc, dtype=np.int64)
    n = K.shape[0]
    n_steps = n - w
    s64 = np.asarray(s_sum, dtype=np.int64)
    keys = K * n + np.arange(n)
    order = np.argsort(keys)
    keys = keys[order]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)

    def keys_below(q):
        o = np.argsort(q)
        out = np.empty_like(q)
        out[o] = np.searchsorted(keys, q[o])
        return out

    p = np.arange(n_steps)
    kl, kr = K[:n_steps], K[w : w + n_steps]
    xstar = K[w]
    a = rank[w : w + n_steps] - keys_below(kr * n + p) + (kr == xstar)
    b = keys_below(kl * n + p + w) - rank[:n_steps] + (kl == xstar)
    c0 = np.bincount(K[: w + 1], minlength=s64.shape[0])
    d0 = int(np.dot(r * c0 - s64, r * c0 - s64))
    delta = 2 * r * r * ((kl != kr) + a - b) + 2 * r * (s64[kl] - s64[kr])
    out = np.empty(n_steps + 1, dtype=np.int64)
    out[0] = d0
    np.cumsum(delta, out=out[1:])
    out[1:] += d0
    return out


class HostStrobeOracle:
    """The exact int64 host span engine of one x* for ``strobe_mine_genome
    (engine_factory=...)``: distances from ``strobe_distances_i64`` and the
    full candidate stream (every window below threshold and the one after
    each), sharing nothing with the port's scan."""

    def __init__(self, profile, xstar: int):
        self.s_sum, self.r = profile.sum_kfv, profile.n_records
        self.w = profile.windowsize - profile.k
        self.scale = 2.0 * profile.k * profile.n_records**2

    def record_stream(self, sc, thr: float, collect_dists: bool = False):
        from kmergma_tpu_torch.models.state_machine import candidate_stream_from_dists

        dists = strobe_distances_i64(sc, self.s_sum, self.w, self.r) / self.scale
        return float(dists[0]), list(candidate_stream_from_dists(dists, thr)), dists if collect_dists else None


def clock(fn, sync):
    """(wall ms, result) of one call of ``fn`` between device synchronises."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


class Ms(float):
    """A time in ms: the median of several timed windows, with their
    minimum as ``.min``."""

    def __new__(cls, times):
        ms = super().__new__(cls, statistics.median(times))
        ms.min = min(times)
        return ms


def kernel_ms(fn, on_card: bool, reps: int = 20, windows: int = 5):
    """(ms per call, last result) of ``fn``: on the card, CUDA events around
    each of ``windows`` windows of ``reps`` back-to-back calls after one
    warm-up call, so one host stall inflates one window, not the row; the
    median window with the fastest as ``.min`` (``Ms``).  On the CPU the
    host wall of three calls (the CPU rehearsal only)."""
    import torch

    out = fn()
    if not on_card:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return Ms(times), out
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return Ms(times), out


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, what binds) of the least time the card could take: the larger
    of the bytes over its memory rate and the operations over its 32-bit
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(*pairs) -> int:
    return max(int((a.to(b.dtype) - b).abs().max()) if a.numel() else 0 for a, b in pairs)


def print_breakdown(what: str, names: list, runs: list, wall_s: float, label: str, skip=()) -> None:
    reps = len(runs)
    print(f"stage breakdown of one {what} call, median of {reps} per stage, shares of the "
          f"{wall_s * 1e3:.3f} ms median wall [{label}]:")
    staged = 0.0
    width = max(len(n) for n in names) + 2
    for i, name in enumerate(names):
        med = statistics.median(run_ms[name] for run_ms in runs)
        if i not in skip:
            staged += med
        print(f"  {name:<{width}} {med:10.3f} ms  {100 * med / (wall_s * 1e3):6.2f}%")
    note = " (indented stages not added)" if skip else ""
    print(f"  {'sum of the stages' + note:<{width}} {staged:10.3f} ms  {100 * staged / (wall_s * 1e3):6.2f}%")


def stage_breakdown(fasta: Path, profile, thr: float, wall_s: float, sync, device, label: str, reps: int = 3) -> None:
    """Print where one ``find_genes`` call on ``fasta`` spends its wall.

    Each stage of the call runs alone with a device synchronise around it
    (median of ``reps`` over all records); shares are of ``wall_s``, the
    unprofiled median wall.  Then one call runs under torch.profiler, after
    a first profiled call that only starts the tracer: the device's busy
    time (the union of its kernel, copy and fill intervals) and the wall
    are both read from that one call."""
    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.state_machine import replay_single
    from kmergma_tpu_torch.ops.align import semiglobal_align_batch
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_threshold
    from kmergma_tpu_torch.utils.fasta import as_records

    k, ws, r = profile.k, profile.windowsize, profile.n_records

    names = [
        "FASTA parse (as_records)", "reference profile (gen_ref_ws_cons)", "threshold estimate",
        "ScanEngine set-up (S to the device)", "H2D incl. host zero-padding (prepare_codes)",
        "planned pass: K1 + plan + K2 + run reduce + D2H", "  of which K1 bitmap alone (incl. l0, bases)",
        "replay (replay_single)", "alignment (semiglobal_align_batch)",
    ]
    runs = []
    for _ in range(reps):
        ms = dict.fromkeys(names, 0.0)
        ms[names[0]], records = clock(lambda: as_records(str(fasta)), sync)
        ms[names[1]], _ = clock(lambda: gen_ref_ws_cons(REF, k), sync)
        ms[names[2]], _ = clock(lambda: estimate_optimal_threshold(profile.mean_kfv, ws, buffer=8.0), sync)
        ms[names[3]], engine = clock(lambda: ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device), sync)
        thr_int = int(engine._thr_int(thr))
        for rec in records:
            nw = len(rec) - ws + 1
            t, prep = clock(lambda: engine.prepare_codes(rec.codes), sync)
            ms[names[4]] += t
            t, (dist0, stream) = clock(lambda: engine._planned_record(prep, nw, thr), sync)
            ms[names[5]] += t
            t, _ = clock(lambda: engine._record_bitmap(prep, nw, thr_int), sync)
            ms[names[6]] += t
            t, raw = clock(lambda: replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=len(rec), buff=50), sync)
            ms[names[7]] += t
            windows = [rec.seq[h.start - 1 : h.stop].decode("ascii").upper() for h in raw]
            if windows:
                t, _ = clock(lambda: semiglobal_align_batch(profile.consensus_ws, windows, -69, -1), sync)
                ms[names[8]] += t
        runs.append(ms)
    print_breakdown("find_genes", names, runs, wall_s, label, skip=(6,))
    device_share("find_genes", lambda: kt.find_genes(str(fasta), REF, verbose=False, device=device), sync, device, label)


def cluster_stage_breakdown(fasta: Path, thrs: list, wall_s: float, sync, device, label: str, reps: int = 3) -> None:
    """Print where one ``find_genes_cluster_mode`` call on ``fasta`` spends
    its wall, each stage run alone with a device synchronise around it,
    median of ``reps`` over all records; shares are of ``wall_s``.  The
    replay and the alignment are timed through ``mine_genome_clusters`` on
    the streams already computed (without, then with, the alignment)."""
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma_tpu_torch.ops.scan import _planned_streams
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_thresholds
    from kmergma_tpu_torch.utils.fasta import as_records

    class Recorded:
        def __init__(self, streams):
            self.streams = iter(streams)

        def record_streams(self, codes, thrs):
            return next(self.streams)

    names = [
        "FASTA parse (as_records)", "clustering (cluster_ref_api)", "threshold estimates",
        "ClusterScanEngine set-up (S to the device)", "H2D incl. host zero-padding (prepare_codes)",
        "bitmap pass: K3 (K8 on the first record), or K5's split pass", "planned passes of all clusters + one D2H",
        "replay (replay_omn)", "alignment, one candidate at a time",
    ]
    runs = []
    for _ in range(reps):
        ms = dict.fromkeys(names, 0.0)
        ms[names[0]], records = clock(lambda: as_records(str(fasta)), sync)
        ms[names[1]], clusters = clock(lambda: eliminate_null_params(cluster_ref_api(REF, 6)), sync)
        ms[names[2]], _ = clock(lambda: estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0), sync)
        ms[names[3]], eng = clock(lambda: ClusterScanEngine(clusters.profiles, k=6, device=device), sync)
        kept, streams = [], []
        for rec in records:
            n = len(rec)
            if n - eng.max_ws - eng.k + 2 < 1:
                continue
            kept.append(rec)
            nws = [n - e.ws + 1 for e in eng.engines]
            thr_ints = [int(e._thr_int(x)) for e, x in zip(eng.engines, thrs)]
            t, prep = clock(lambda: eng.prepare_codes(rec.codes), sync)
            ms[names[4]] += t
            split = max(nws) < eng.fused_min_windows
            t, bm = clock(lambda: (eng._split_bitmaps if split else eng._fused_bitmaps)(prep, nws, thr_ints), sync)
            ms[names[5]] += t
            mis = [min(nw - 1, n - eng.max_ws - eng.k + 2) for nw in nws]
            t, pairs = clock(lambda: _planned_streams(eng.engines, prep, list(bm), nws, thrs, mis), sync)
            ms[names[6]] += t
            streams.append(pairs)
        kw = dict(thr_vec=thrs, buff=100)
        ms[names[7]], _ = clock(lambda: mine_genome_clusters(kept, clusters.profiles, do_align=False, engine=Recorded(streams), **kw), sync)
        t, _ = clock(lambda: mine_genome_clusters(kept, clusters.profiles, engine=Recorded(streams), **kw), sync)
        ms[names[8]] = t - ms[names[7]]
        runs.append(ms)
    print_breakdown("find_genes_cluster_mode", names, runs, wall_s, label)


def strobe_stage_breakdown(fasta: Path, profile, thr: float, wall_s: float, sync, device, label: str, reps: int = 3) -> None:
    """Print where one ``strobemer_find_genes`` call on ``fasta`` spends its
    wall, each stage run alone with a device synchronise around it, median
    of ``reps`` over all records; shares are of ``wall_s``.  Then the
    device's busy share of one profiled call."""
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.state_machine import replay_single
    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons
    from kmergma_tpu_torch.ops.align import align_hits_batch
    from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes_torch
    from kmergma_tpu_torch.utils.fasta import as_records

    k, ws = profile.k, profile.windowsize
    w = ws - k
    names = [
        "FASTA parse (as_records)", "strobe profile (gen_strobe_ref_ws_cons)",
        "H2D of int8 genome codes + strobe extraction on the device", "StrobeSpanEngine set-up (S - r e_x to the device)",
        "device zero-padding of the strobe codes (prepare_codes)",
        "planned pass: K4r exact bitmap + plan + K2 + run reduce + D2H", "  of which the K4r exact bitmap alone",
        "replay (replay_single)", "alignment (align_hits_batch, -69/-5)",
    ]
    runs = []
    for _ in range(reps):
        ms = dict.fromkeys(names, 0.0)
        ms[names[0]], records = clock(lambda: as_records(str(fasta)), sync)
        ms[names[1]], _ = clock(lambda: gen_strobe_ref_ws_cons(REF), sync)
        for rec in records:
            n_steps = len(rec) - ws - 1
            t, sc = clock(lambda: strobe_2_mer_codes_torch(torch.from_numpy(rec.codes).to(device), 2, 3, 5, 5), sync)
            ms[names[2]] += t
            t, eng = clock(lambda: StrobeSpanEngine(profile, int(sc[w]), device=device), sync)
            ms[names[3]] += t
            t, prep = clock(lambda: eng.prepare_codes(sc[: n_steps + w]), sync)
            ms[names[4]] += t
            t, (dist0, stream) = clock(lambda: eng._planned_record(prep, n_steps + 1, thr), sync)
            ms[names[5]] += t
            t, _ = clock(lambda: eng._record_bitmap(prep, n_steps + 1, int(eng._thr_int(thr))), sync)
            ms[names[6]] += t
            t, raw = clock(lambda: replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=len(rec), buff=50, cmi_offset=0), sync)
            ms[names[7]] += t
            windows = [rec.seq[h.start - 1 : h.stop].decode("ascii").upper() for h in raw]
            if windows:
                t, _ = clock(lambda: align_hits_batch(profile.consensus[:ws], windows, -69, -5), sync)
                ms[names[8]] += t
        runs.append(ms)
    print_breakdown("strobemer_find_genes", names, runs, wall_s, label, skip=(6,))
    device_share("strobemer_find_genes", lambda: kt.strobemer_find_genes(str(fasta), REF, verbose=False, device=device),
                 sync, device, label)


def device_share(what: str, call, sync, device, label: str) -> None:
    """Run ``call`` under torch.profiler, after a first profiled call that
    only starts the tracer, and print the device's busy time (the union of
    its kernel, copy and fill intervals) and the wall, both from that one
    call, with the ten largest device totals by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    on_card = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with torch_profile(activities=activities):
        call()
    with torch_profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in dev_events):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    print(f"profiled {what} call: wall {wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"(union of {len(dev_events)} device intervals), busy share {busy_us / 1e3 / wall_ms:.4f}, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.4f} [{label}]")
    totals: dict = {}
    for ev in dev_events:
        n, t = totals.get(ev.name, (0, 0.0))
        totals[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    for name, (n, t) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  device: {t / 1e3:9.3f} ms in {n:4d} x {name[:90]}")


def timed_calls(call, sync, runs: int) -> tuple[list, object]:
    """Host wall in seconds of ``runs`` calls after one warm-up, each
    between device synchronises; returns (times, last result)."""
    times = []
    for i in range(runs + 1):
        sync()
        t0 = time.perf_counter()
        out = call()
        sync()
        if i:
            times.append(time.perf_counter() - t0)
    return times, out


class Launches:
    """The kernel wrappers' launch counts: set to 0, read."""

    def __init__(self):
        from kmergma_tpu_torch.ops.scan_cluster_fused import fused_cluster_record_bitmaps, lookup_roundtrip
        from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps
        from kmergma_tpu_torch.bench import hash_genome
        from kmergma_tpu_torch.ops.scan_kernels import (
            codes_pair_ab_kcodes, codes_pair_multi, match_counts, pair_ab_from_kcodes,
        )

        self.wrappers = {
            "fused_record_bitmaps": fused_record_bitmaps, "match_counts": match_counts,
            "fused_cluster_record_bitmaps": fused_cluster_record_bitmaps,
            "codes_pair_multi": codes_pair_multi, "lookup_roundtrip": lookup_roundtrip,
            "codes_pair_ab_kcodes": codes_pair_ab_kcodes, "pair_ab_from_kcodes": pair_ab_from_kcodes,
            "hash_genome": hash_genome,
        }

    def reset(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.wrappers.items()}


def entry(name, source, replaces, launches, err, ms, plain_ms, n_bytes, n_ops, library_ms=None, **extra) -> dict:
    """One kernel's row: ``ms``, ``plain_ms`` and ``library_ms`` are medians
    of timed windows (``kernel_ms``), each with its fastest window beside it
    (``*_min``)."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    row = {"name": name, "route": "cuda", "source": f"kmergma_tpu_torch/csrc/{source}", "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": float(ms), "plain_ms": float(plain_ms),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None if library_ms is None else float(library_ms)}
    for key, value in (("ms_min", ms), ("plain_ms_min", plain_ms), ("library_ms_min", library_ms)):
        if value is not None:
            row[key] = getattr(value, "min", float(value))
    row.update(extra)
    return row


def single_profile_phase(ctx) -> list:
    """K1 and K2 against their twins, the goldens, and ``find_genes`` on
    the synthetic genome against the int64 host oracle."""
    import numpy as np

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.miner import mine_genome
    from kmergma_tpu_torch.ops.scan import (
        ScanEngine, _first_window_l0, _k1_halo, scan_window_distances,
    )
    from kmergma_tpu_torch.ops.scan_cluster_fused import cluster_launch_shape
    from kmergma_tpu_torch.ops.scan_fused import _k1_args, fused_record_bitmaps, fused_record_bitmaps_plain
    from kmergma_tpu_torch.ops.scan_host import HostScanEngine
    from kmergma_tpu_torch.ops.scan_kernels import scan_window_distances_kernel
    from kmergma_tpu_torch.utils.native import scan_rolling_i64_native

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    profile, thr, contigs, runs = ctx["profile"], ctx["thr"], ctx["contigs"], ctx["runs"]
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)

    # --- K1 vs its plain twin: one whole contig --------------------------
    record = contigs[0]
    nw = record.shape[0] - ws + 1
    prep = engine.prepare_codes(record)
    depth = engine.bound_depth
    thr_int = int(engine._thr_int(thr))
    n_tiles = -(-nw // engine.fused_t)
    l0 = _first_window_l0(prep, engine.s_dev, k=k, ws=ws, r=r, depth=depth)
    kw = dict(k=k, ws=ws, r=r, depth=depth, t=engine.fused_t, block=engine.block, n_tiles=n_tiles)
    k1_ms, bm = kernel_ms(lambda: fused_record_bitmaps(prep, engine.s_dev, thr_int, l0, nw, **kw), on_card)
    k1_plain_ms, bm_plain = kernel_ms(lambda: fused_record_bitmaps_plain(prep, engine.s_dev, thr_int, l0, nw, **kw), on_card, reps=3)
    k1_err = max_err((bm, bm_plain))
    n_active = int(bm.sum())
    n_win = n_tiles * engine.fused_t
    k1_io = (n_win + _k1_halo(ws - k + 1) + 4 * 4**k + 4 * bm.numel(), (4 * depth + PROFILE_OPS_PER_WINDOW) * n_win)
    print(
        f"K1 fused_record_bitmaps, {record.shape[0]} bp record, k={k} ws={ws} depth={depth} "
        f"thr_int={thr_int}: {k1_ms:.3f} ms, plain twin {k1_plain_ms:.3f} ms, bound {bound(*k1_io)[0]:.4f} ms, "
        f"bit-identical={k1_err == 0}, active blocks {n_active}/{bm.numel()} [{label}]"
    )
    require(k1_err == 0, "K1 bitmap differs from its plain twin")
    require(n_active > 0, "K1 flagged no block on a record with planted genes")
    k1_stages = None
    if on_card:
        shapes = [cluster_launch_shape(1, k, engine.fused_t, ws - k + 1, ws - k + 1, n_tiles, emit=e) for e in (False, True)]
        p1, scan, p2 = k3_stage_ms(_k1_args(prep, engine.s_dev, thr_int, nw, **kw), l0.view(1))
        k1_stages = {"pass1_ms": p1, "scan_ms": scan, "pass2_ms": p2}
        print(
            f"K1 (K3's kernel at m = 1) per stage, median of 20 calls, CUDA events around each: pass 1 {p1:.4f} ms, "
            f"tile-base scan {scan:.4f} ms, pass 2 {p2:.4f} ms, sum {p1 + scan + p2:.4f} ms; {n_tiles} tiles, "
            f"grids {shapes[0]['grid']} and {shapes[1]['grid']} of {shapes[1]['threads']} threads, resident blocks "
            f"per SM {shapes[0]['blocks_per_sm']} and {shapes[1]['blocks_per_sm']} [{label}]"
        )

    # --- K2 vs its plain twin: region rows and the whole-record scan's rows
    k2 = k2_measure(engine, prep, bm, nw, ctx["whole_bp"], on_card, label)
    k2_err = max(k2["err"], k2["whole_err"])

    # --- K2 on a whole-record distance scan ------------------------------
    whole_bp = ctx["whole_bp"]
    whole = prep[: whole_bp + ws - 1]
    kd_ms, d_kernel = kernel_ms(lambda: scan_window_distances_kernel(whole, engine.s_dev, k, ws, r), on_card, reps=5)
    pd_ms, d_plain = kernel_ms(lambda: scan_window_distances(whole, engine.s_dev, k, ws, r), on_card, reps=1)
    kd_err = max_err((d_kernel, d_plain))
    oracle = scan_rolling_i64_native(record[: whole_bp + ws - 1], profile.sum_kfv, k, ws, r)
    oracle_ok = oracle is None or np.array_equal(d_kernel.cpu().numpy().astype(np.int64), oracle)
    print(
        f"K2 whole-record distances, {whole_bp} windows (tiles of 2048): {kd_ms:.3f} ms, "
        f"plain twin {pd_ms:.3f} ms, bit-identical={kd_err == 0}, "
        f"int64 host oracle {'agrees' if oracle is not None and oracle_ok else 'unavailable' if oracle is None else 'DIFFERS'} [{label}]"
    )
    require(kd_err == 0 and oracle_ok, "K2 whole-record distances differ")
    del prep, bm, bm_plain, whole, d_kernel, d_plain

    # --- goldens through find_genes ------------------------------------------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hits = kt.find_genes(str(DATA / "Alp_V_locus.fasta"), REF, verbose=False, device=device)[0]
        require([h.description for h in hits] == GOLDEN_LOCUS, "Alp_V_locus golden hits")
        hits, loci = kt.find_genes(str(DATA / "Loci.fasta"), REF, verbose=False, do_return_hit_loci=True, device=device)
        require(len(hits) == 7 and loci == GOLDEN_LOCI, f"Loci golden: {len(hits)} hits, loci {loci}")
        hits, dists = kt.find_genes(
            str(DATA / "Loci.fasta"), REF, kmer_dist_thr=10, do_align=False,
            do_return_dists=True, verbose=False, device=device,
        )
        require(dists.shape[0] == 484127 and round(float(dists.mean())) == 46 and len(hits) == 3,
                f"Loci distances golden: {dists.shape[0]} dists, mean {float(dists.mean())}, {len(hits)} hits")
    print("goldens: Alp_V_locus 3 hits exact; Loci 7 hits, loci as pinned; "
          f"Loci do_return_dists {dists.shape[0]} distances, mean {float(dists.mean()):.4f}")

    # --- the main path at size: find_genes on the synthetic genome ----------
    fasta, total_bp = ctx["fasta"], ctx["total_bp"]
    ctx["launches"].reset()
    times, out = timed_calls(
        lambda: kt.find_genes(str(fasta), REF, verbose=False, do_return_hit_loci=True, device=device), sync, runs
    )
    hits = out[0]
    ctx["uninterrupted"]["single"] = out
    launches = ctx["launches"].read()
    t_med = statistics.median(times)
    print(
        f"find_genes {total_bp} bp ({len(contigs)} contigs): median of {runs} {t_med:.3f} s "
        f"= {total_bp / t_med / 1e6:.2f} Mbp/s (runs {', '.join(f'{x:.3f}' for x in times)} s), "
        f"{len(hits)} hits [{label}]"
    )
    t0 = time.perf_counter()
    oracle_res = mine_genome(str(fasta), profile, thr=thr, engine=HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r))
    print(f"int64 host oracle (HostScanEngine): {time.perf_counter() - t0:.3f} s, {len(oracle_res.hits)} hits [{label}]")
    stage_breakdown(fasta, profile, thr, t_med, sync, device, label, reps=runs)
    require(len(hits) > 0, "no hits on the planted genome")
    require(
        [(h.description, h.seq) for h in hits] == [(h.description, h.seq) for h in oracle_res.hits],
        "find_genes hits differ from the int64 host oracle",
    )
    print(f"hits equal the host oracle's; launch counts over the {runs + 1} runs: {launches}")
    if on_card:
        require(launches["fused_record_bitmaps"] > 0 and launches["match_counts"] > 0,
                f"a kernel of the single-profile path never launched: {launches}")
    return [
        entry("fused_record_bitmaps", "fused_cluster_bitmaps.cu", "kmergma_tpu/ops/scan_fused.py:165",
              launches["fused_record_bitmaps"], k1_err, k1_ms, k1_plain_ms, *k1_io, stages_ms=k1_stages),
        entry("match_counts", "match_counts.cu", "kmergma_tpu/ops/scan_pallas.py:43",
              launches["match_counts"], k2_err, k2["ms"], k2["plain_ms"], *k2["io"], device_ms=k2["device_ms"],
              whole_record=k2["whole"]),
    ]


def k2_io(n_rows: int, t: int, w: int) -> tuple[int, int]:
    """(bytes, operations) K2's function needs on n_rows rows of t + w K
    codes: each row's codes read once and its t results written once; w - 1
    histogram increments a row to start, then the sliding histogram's O(1)
    operations a position and the match term's compare and add."""
    return 4 * n_rows * (t + w) + 4 * n_rows * t, n_rows * (w - 1) + (HIST_OPS_PER_POSITION + 2) * n_rows * t


def k2_measure(engine, prep, bm, nw: int, whole_bp: int, on_card: bool, label: str) -> dict:
    """K2 against its plain twin at the main path's two shapes: the planned
    region rows (``_plan_regions`` over K1's bitmap, at most 256 rows of
    ``engine.rspan`` transitions) and the whole-record scan's overlapping
    rows of 2048 transitions over ``whole_bp`` windows (row stride 2048,
    as ``scan_window_distances_kernel`` tiles a record).  Wrapper ms
    (``kernel_ms``), device ms (``queued_device_ms``, on the card) and the
    bound's bytes and operations: K2 is K4r's function at depth w - 1 plus
    [K[p] == K[p+w]] - 1, so a row needs w - 1 histogram increments to
    start and O(1) operations a position after (``k2_io``), not the 2 w
    compares a position its kernel does; that count is printed beside."""
    import torch

    from kmergma_tpu_torch.ops.scan import _plan_regions, rolling_kmer_codes
    from kmergma_tpu_torch.ops.scan_kernels import _match_counts_plain, match_counts

    k, ws, rspan = engine.k, engine.ws, engine.rspan
    w = ws - k + 1
    device = prep.device
    starts, nvr = _plan_regions(bm.reshape(-1).bool(), nw, rspan, engine.block, 256)
    rows = prep[starts[:, None] + torch.arange(rspan + ws - 1, device=device)[None, :]]
    tiles = torch.nn.functional.pad(rolling_kmer_codes(rows, k), (0, 1))
    ms, ab = kernel_ms(lambda: match_counts(tiles, w, rspan), on_card)
    plain_ms, ab_plain = kernel_ms(lambda: _match_counts_plain(tiles, w, rspan), on_card, reps=3)
    err = max_err((ab, ab_plain))
    n_rows = tiles.shape[0]
    io = k2_io(n_rows, rspan, w)
    device_ms = queued_device_ms(lambda: match_counts(tiles, w, rspan)) if on_card else None

    t = 2048
    kcodes = rolling_kmer_codes(prep[: whole_bp + ws - 1], k)
    n_tiles = -(-whole_bp // t)
    kcodes_pad = torch.nn.functional.pad(kcodes, (0, n_tiles * t + w - kcodes.shape[0]))
    wtiles = kcodes_pad.unfold(0, t + w, t)
    wms, wab = kernel_ms(lambda: match_counts(wtiles, w, t), on_card)
    whole_err = max_err((wab, _match_counts_plain(wtiles, w, t)))
    wdev = queued_device_ms(lambda: match_counts(wtiles, w, t)) if on_card else None
    wio = k2_io(n_tiles, t, w)
    dev = "" if device_ms is None else f", device {device_ms:.5f} ms"
    wdev_s = "" if wdev is None else f", device {wdev:.5f} ms"
    # the count of the kernel's algorithm beside it: 2 w compares and adds a position
    loop = [bound(n_bytes, 4 * w * n * tt)[0] for (n_bytes, _), n, tt in ((io, n_rows, rspan), (wio, n_tiles, t))]
    print(
        f"K2 match_counts, {n_rows} region rows x {tiles.shape[1]} K codes ({int(nvr)} active regions): "
        f"{ms:.4f} ms (fastest window {ms.min:.4f}){dev}, plain twin {plain_ms:.3f} ms, bound {bound(*io)[0]:.5f} ms "
        f"({bound(*io)[1]}; counted as the depth loop's 4 w operations a position: {loop[0]:.5f} ms), "
        f"bit-identical={err == 0}; whole-record rows, {n_tiles} x {t + w} K codes at stride {t}: {wms:.4f} ms "
        f"(fastest window {wms.min:.4f}){wdev_s}, bound {bound(*wio)[0]:.5f} ms ({bound(*wio)[1]}; depth loop "
        f"{loop[1]:.5f} ms), bit-identical={whole_err == 0} [{label}]"
    )
    require(err == 0, "K2 region rows differ from the plain twin")
    require(whole_err == 0, "K2 whole-record rows differ from the plain twin")
    whole = {"rows": n_tiles, "ms": float(wms), "ms_min": wms.min, "device_ms": wdev, "bound_ms": bound(*wio)[0]}
    return {"n_rows": n_rows, "ms": ms, "plain_ms": plain_ms, "err": err, "io": io, "device_ms": device_ms,
            "whole": whole, "whole_err": whole_err}


def cluster_phase(ctx) -> list:
    """K3, K8 and K5 against their twins, the cluster goldens, both routes,
    and ``find_genes_cluster_mode`` on the genome plus a short contig
    against the int64 host cluster oracle."""
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.ops.scan import _first_window_l0, _k1_halo
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma_tpu_torch.ops.scan_cluster_fused import (
        _k3_args, _lookup_roundtrip_plain, cluster_launch_shape, cluster_tables_in_smem, fused_cluster_record_bitmaps,
        fused_cluster_record_bitmaps_plain, lookup_roundtrip,
    )
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_thresholds

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    contigs, runs, clusters, cthrs = ctx["contigs"], ctx["runs"], ctx["clusters"], ctx["cthrs"]
    profiles = clusters.profiles
    k = 6
    ceng = ClusterScanEngine(profiles, k=k, device=device)
    m = len(profiles)
    depth = ceng.groups[0][1]
    widths = [ws_c - k + 1 for ws_c, _r in ceng.specs]
    print(
        f"cluster mode: {m} clusters, windowsizes {clusters.windowsizes}, R {[p.n_records for p in profiles]}, "
        f"{len(ceng.groups)} windowsize groups, pair depth {depth}, auto thresholds (buffer 7) {cthrs} [{label}]"
    )

    # --- K3 vs its plain twin: one whole contig, all clusters --------------
    record = contigs[0]
    nws = [record.shape[0] - ws_c + 1 for ws_c, _r in ceng.specs]
    cprep = ceng.prepare_codes(record)
    cthr_ints = [int(e._thr_int(x)) for e, x in zip(ceng.engines, cthrs)]
    l0s = torch.stack([_first_window_l0(cprep, e.s_dev, k=k, ws=e.ws, r=e.r, depth=depth) for e in ceng.engines])
    n_tiles = -(-max(nws) // ceng.fused_t)
    kw3 = dict(k=k, specs=ceng.specs, depth=depth, t=ceng.fused_t, block=ceng.block, n_tiles=n_tiles)
    k3_ms, bm3 = kernel_ms(lambda: fused_cluster_record_bitmaps(cprep, ceng.s_stack, cthr_ints, l0s, nws, **kw3), on_card)
    k3_plain_ms, bm3_plain = kernel_ms(
        lambda: fused_cluster_record_bitmaps_plain(cprep, ceng.s_stack, cthr_ints, l0s, nws, **kw3), on_card, reps=1
    )
    k3_err = max_err((bm3, bm3_plain))
    n_win = n_tiles * ceng.fused_t
    k3_io = (n_win + _k1_halo(max(widths)) + 4 * m * 4**k + 4 * bm3.numel(), (4 * depth + PROFILE_OPS_PER_WINDOW * m) * n_win)
    placement = "the plain twin's gather"
    if on_card:
        placement = "shared memory" if cluster_tables_in_smem(m, k, ceng.fused_t, min(widths), max(widths)) else "__ldg"
    print(
        f"K3 fused_cluster_record_bitmaps, {record.shape[0]} bp record, {m} clusters, tables read through {placement}: "
        f"{k3_ms:.3f} ms, plain twin {k3_plain_ms:.3f} ms, bound {bound(*k3_io)[0]:.4f} ms, bit-identical={k3_err == 0}, "
        f"active blocks per cluster {[int(x) for x in bm3.sum(dim=1)]} of {bm3.shape[1]} [{label}]"
    )
    require(k3_err == 0, "K3 bitmaps differ from the plain twin")
    require(int(bm3.sum()) > 0, "K3 flagged no block on a record with planted genes")
    k3_stages = None
    if on_card:
        p1, scan, p2 = k3_stage_ms(_k3_args(cprep, ceng.s_stack, cthr_ints, nws, **kw3), l0s)
        k3_stages = {"pass1_ms": p1, "scan_ms": scan, "pass2_ms": p2}
        shapes = [cluster_launch_shape(m, k, ceng.fused_t, min(widths), max(widths), n_tiles, emit=e) for e in (False, True)]
        print(
            f"K3 per stage, median of 20 calls, CUDA events around each: pass 1 {p1:.4f} ms, tile-base scan "
            f"{scan:.4f} ms, pass 2 {p2:.4f} ms; {n_tiles} tiles, pass 1 grid {shapes[0]['grid']} and pass 2 grid "
            f"{shapes[1]['grid']} of {shapes[1]['threads']} threads, resident blocks per SM {shapes[0]['blocks_per_sm']} "
            f"and {shapes[1]['blocks_per_sm']} on {shapes[1]['sms']} SMs [{label}]"
        )

    # --- K3 on the __ldg route at size: k = 7, six tables of 64 KB --------------
    clusters7 = eliminate_null_params(cluster_ref_api(REF, 7))
    ceng7 = ClusterScanEngine(clusters7.profiles, k=7, device=device)
    widths7 = [ws_c - 6 for ws_c, _r in ceng7.specs]
    placement7 = "the plain twin's gather"
    if on_card:
        placement7 = "shared memory" if cluster_tables_in_smem(len(ceng7.specs), 7, ceng7.fused_t, min(widths7), max(widths7)) else "__ldg"
        require(placement7 == "__ldg", f"the k = 7 cluster tables took {placement7}, not __ldg")
    thrs7 = estimate_optimal_thresholds(clusters7.kfvs, clusters7.windowsizes, buffer=7.0)
    k3_ldg_err, k3_ldg_active = k3_twin_err(ceng7, cprep[: record.shape[0]], thrs7)
    print(f"K3 on the __ldg route: k = 7, {len(ceng7.specs)} clusters, {record.shape[0]} bp record, tables read through "
          f"{placement7}: bit-identical={k3_ldg_err == 0}, {k3_ldg_active} active blocks [{label}]")
    require(k3_ldg_err == 0, "K3 differs from its plain twin on the k = 7 (__ldg) record")
    require(k3_ldg_active > 0, "K3 flagged no block on the k = 7 record with planted genes")
    del ceng7

    # --- K8: every table entry through K3's lookup ------------------------
    rt = dict(t=ceng.fused_t, w_min=min(widths), w_max=max(widths))
    k8_ms, back = kernel_ms(lambda: lookup_roundtrip(ceng.s_stack, **rt), on_card)
    k8_plain_ms, back_plain = kernel_ms(lambda: _lookup_roundtrip_plain(ceng.s_stack), on_card)
    entries = torch.arange(ceng.s_stack.shape[1], device=ceng.s_stack.device)
    k8_lib_ms, _ = kernel_ms(lambda: torch.index_select(ceng.s_stack, 1, entries), on_card)
    k8_err = max_err((back, ceng.s_stack), (back, back_plain))
    k8_io = (2 * 4 * ceng.s_stack.numel(), 0)
    print(
        f"K8 lookup_roundtrip, {m} x {4**k} entries: {k8_ms:.4f} ms, plain twin {k8_plain_ms:.4f} ms, "
        f"one index_select {k8_lib_ms:.4f} ms, bound {bound(*k8_io)[0]:.5f} ms, equal to the stack={k8_err == 0} [{label}]"
    )
    if on_card:
        k8_dev, k8_names = device_ms_per_call(lambda: lookup_roundtrip(ceng.s_stack, **rt))
        lib_dev, lib_names = device_ms_per_call(lambda: torch.index_select(ceng.s_stack, 1, entries))
        k8_q = queued_device_ms(lambda: lookup_roundtrip(ceng.s_stack, **rt))
        lib_q = queued_device_ms(lambda: torch.index_select(ceng.s_stack, 1, entries))
        print(
            f"K8 device time per call: torch.profiler {k8_dev:.5f} ms ({k8_names}), CUDA events over 20 calls "
            f"queued behind a spin {k8_q:.5f} ms, against CUDA events back to back {k8_ms:.4f} ms; index_select "
            f"{lib_dev:.5f} ms ({lib_names}), queued {lib_q:.5f} ms, back to back {k8_lib_ms:.4f} ms [{label}]"
        )
    require(k8_err == 0, "K8 read a table entry back wrong")
    del cprep, bm3, bm3_plain, back, back_plain

    # --- K5 vs its plain twin: the split pass's shapes ----------------------
    k5 = k5_measure(ceng, record, (SHORT_CONTIG_BP, FRAGMENT_BP, ctx["whole_bp"]), on_card, label)
    k5_err = max(v["err"] for v in k5.values())

    # --- cluster goldens through find_genes_cluster_mode (the split route) --
    ctx["launches"].reset()
    hits = kt.find_genes_cluster_mode(
        str(DATA / "Alp_V_locus.fasta"), REF, kmer_dist_thrs=GOLDEN_CLUSTER_THRS, buffer=100, verbose=False, device=device,
    )[0]
    golden_launches = ctx["launches"].read()
    require([h.description for h in hits] == GOLDEN_CLUSTER, "Alp_V_locus cluster golden hits")
    print(f"cluster goldens: Alp_V_locus 3 hits exact; launch counts {golden_launches} [{label}]")
    if on_card:
        require(golden_launches["codes_pair_multi"] > 0 and golden_launches["match_counts"] > 0,
                f"the cluster golden did not run K5 and K2: {golden_launches}")

    # --- both routes agree ------------------------------------------------------
    # the short contig takes the split route by default; a whole contig K3
    short_contig = ctx["short_contig"]
    for codes_r, other in ((short_contig, 1), (record, 1 << 30)):
        a = ClusterScanEngine(profiles, k=k, device=device)
        b = ClusterScanEngine(profiles, k=k, device=device)
        b.fused_min_windows = other
        sa, sb = a.record_streams(codes_r, cthrs), b.record_streams(codes_r, cthrs)
        require(sa == sb, f"K3 and split-route streams differ on a {codes_r.shape[0]} bp record")
        require(any(x[1] for x in sa), f"no cluster stream entries on a {codes_r.shape[0]} bp record with planted genes")
        print(f"both routes agree on a {codes_r.shape[0]} bp record: {[len(x[1]) for x in sa]} stream entries [{label}]")

    # --- the cluster path at size ------------------------------------------------
    ccontigs = [*contigs, short_contig]
    ctotal = sum(c.shape[0] for c in ccontigs)
    fasta = ctx["cluster_fasta"]
    write_fasta(fasta, ccontigs)
    ctx["launches"].reset()
    times, out = timed_calls(
        lambda: kt.find_genes_cluster_mode(str(fasta), REF, verbose=False, do_return_hit_loci=True, device=device),
        sync, runs,
    )
    chits = out[0]
    ctx["uninterrupted"]["cluster"] = out
    claunches = ctx["launches"].read()
    t_med = statistics.median(times)
    print(
        f"find_genes_cluster_mode {ctotal} bp ({len(ccontigs)} contigs, the last {SHORT_CONTIG_BP} bp): "
        f"median of {runs} {t_med:.3f} s = {ctotal / t_med / 1e6:.2f} Mbp/s "
        f"(runs {', '.join(f'{x:.3f}' for x in times)} s), {len(chits)} hits [{label}]"
    )
    t0 = time.perf_counter()
    coracle = mine_genome_clusters(str(fasta), profiles, thr_vec=cthrs, buff=100, engine=HostClusterOracle(profiles, k))
    print(f"int64 host cluster oracle ({m} x HostScanEngine): {time.perf_counter() - t0:.3f} s, "
          f"{len(coracle.hits)} hits [{label}]")
    cluster_stage_breakdown(fasta, cthrs, t_med, sync, device, label, reps=runs)
    device_share("find_genes_cluster_mode",
                 lambda: kt.find_genes_cluster_mode(str(fasta), REF, verbose=False, device=device), sync, device, label)
    require(len(chits) > 0, "no cluster hits on the planted genome")
    require(
        [(h.description, h.seq) for h in chits] == [(h.description, h.seq) for h in coracle.hits],
        "find_genes_cluster_mode hits differ from the int64 host cluster oracle",
    )
    print(f"cluster hits equal the host oracle's; launch counts over the {runs + 1} runs: {claunches}")
    if on_card:
        missing = [n for n in ("fused_cluster_record_bitmaps", "codes_pair_multi", "lookup_roundtrip", "match_counts")
                   if claunches[n] == 0]
        require(not missing, f"a kernel of the cluster path never launched: {claunches}")
    frag = fragmented_phase(ctx, short_contig)
    return [
        entry("fused_cluster_record_bitmaps", "fused_cluster_bitmaps.cu", "kmergma_tpu/ops/scan_cluster_fused.py:187",
              claunches["fused_cluster_record_bitmaps"], k3_err, k3_ms, k3_plain_ms, *k3_io, stages_ms=k3_stages),
        entry("lookup_roundtrip", "fused_cluster_bitmaps.cu", "kmergma_tpu/ops/scan_cluster_fused.py:169",
              claunches["lookup_roundtrip"], k8_err, k8_ms, k8_plain_ms, *k8_io, library_ms=k8_lib_ms),
        entry("codes_pair_multi", "pair_multi.cu", "kmergma_tpu/ops/scan_pallas.py:368",
              claunches["codes_pair_multi"], k5_err, k5[SHORT_CONTIG_BP]["ms"], k5[SHORT_CONTIG_BP]["plain_ms"],
              *k5[SHORT_CONTIG_BP]["io"], device_ms=k5[SHORT_CONTIG_BP]["device_ms"],
              shapes={str(n_bp): {"ms": float(v["ms"]), "ms_min": v["ms"].min, "device_ms": v["device_ms"],
                                  "bound_ms": bound(*v["io"])[0], "bound_by": bound(*v["io"])[1], "launch": v["shape"]}
                      for n_bp, v in k5.items()},
              fragmented=frag),
    ]


def strobe_phase(ctx) -> list:
    """K4r against its twin on one contig's strobe codes, the strobe goldens,
    and ``strobemer_find_genes`` on the genome against the int64 host
    oracle of the strobe recurrence."""
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma_tpu_torch.ops.scan_kernels import _codes_pair_ab_kcodes_plain, codes_pair_ab_kcodes
    from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes_torch

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    contigs, runs = ctx["contigs"], ctx["runs"]
    thr = 30.0  # strobemer_find_genes' default kmer_dist_thr (no estimate)
    profile = gen_strobe_ref_ws_cons(REF)
    k, ws = profile.k, profile.windowsize
    w = ws - k
    print(
        f"strobemers: s {profile.s}, w_min {profile.w_min}, w_max {profile.w_max}, q {profile.q}, "
        f"{4 ** (2 * profile.s)} bins, windowsize {ws}, R {profile.n_records}, k_eff {k}; span engine k 1, "
        f"ws {w}, exact pair depth {w - 1}, thr {thr} [{label}]"
    )

    # --- K4r vs its plain twin: one contig's strobe codes ------------------
    record = contigs[0]
    n_steps = record.shape[0] - ws - 1
    sc = strobe_2_mer_codes_torch(torch.from_numpy(record).to(device), profile.s, profile.w_min, profile.w_max, profile.q)
    eng = StrobeSpanEngine(profile, int(sc[w]), device=device)
    prep = eng.prepare_codes(sc[: n_steps + w])
    nw = n_steps + 1
    nt, nkc, depth = nw - 1, nw + w - 1, w - 1
    n_high = int((prep[: n_steps + w] >= 128).sum())
    require(prep.dtype == torch.uint8 and n_high > 0, f"strobe codes: {prep.dtype}, {n_high} codes >= 128")
    args = (prep, 1, w, nt, nkc, depth)
    k4r_ms, (ab, kc) = kernel_ms(lambda: codes_pair_ab_kcodes(*args), on_card)
    k4r_plain_ms, (ab_p, kc_p) = kernel_ms(lambda: _codes_pair_ab_kcodes_plain(*args), on_card, reps=1)
    k4r_err = max_err((ab, ab_p), (kc, kc_p))
    # the sliding-histogram route's function: nt + w codes read once, ab and
    # the K codes written once; the recurrence's O(1) operations a position
    # (two bin reads, two bin updates, the subtraction, the K code's store)
    k4r_io = (nt + w + 4 * (nt + nkc), HIST_OPS_PER_POSITION * nt)
    # the depth loop's operations at this depth, the count of the TPU kernel's
    # algorithm (the row's bound before the sliding histogram)
    loop_bound = bound(nt + w + 4 * (nt + nkc), 4 * depth * nt)
    print(
        f"K4r codes_pair_ab_kcodes (sliding-histogram route), {record.shape[0]} bp record as {nkc} uint8 strobe codes "
        f"({n_high} >= 128), k 1, w {w}, depth {depth}: {k4r_ms:.4f} ms (fastest window {k4r_ms.min:.4f}), plain twin "
        f"{k4r_plain_ms:.3f} ms, bound {bound(*k4r_io)[0]:.4f} ms ({bound(*k4r_io)[1]}; counted as the depth loop's "
        f"4 * depth operations a position: {loop_bound[0]:.4f} ms), bit-identical={k4r_err == 0} [{label}]"
    )
    require(k4r_err == 0, "K4r differs from its plain twin")
    del sc, prep, ab, kc, ab_p, kc_p

    # --- K4r's register-blocked route: int32 strobe codes at s = 3 ----------
    p3 = gen_strobe_ref_ws_cons(REF, s=3, w_min=3, w_max=6)
    w3 = p3.windowsize - p3.k
    rec3 = record[: ctx["whole_bp"]]
    n3 = rec3.shape[0] - p3.windowsize - 1
    sc3 = strobe_2_mer_codes_torch(torch.from_numpy(rec3).to(device), p3.s, p3.w_min, p3.w_max, p3.q)
    prep3 = StrobeSpanEngine(p3, int(sc3[w3]), device=device).prepare_codes(sc3[: n3 + w3])
    require(prep3.dtype == torch.int32 and int(prep3.max()) >= 256, f"s = 3 strobe codes: {prep3.dtype}")
    args3 = (prep3, 1, w3, n3, n3 + w3, w3 - 1)
    loop_ms, (ab3, kc3) = kernel_ms(lambda: codes_pair_ab_kcodes(*args3), on_card, reps=5)
    ab3_p, kc3_p = _codes_pair_ab_kcodes_plain(*args3)
    loop_err = max_err((ab3, ab3_p), (kc3, kc3_p))
    print(
        f"K4r's register-blocked route, {rec3.shape[0]} bp record as {n3 + w3} int32 strobe codes at s = 3 "
        f"({4 ** (2 * p3.s)} values), w {w3}, depth {w3 - 1}: {loop_ms:.4f} ms (fastest window {loop_ms.min:.4f}), "
        f"bit-identical={loop_err == 0} [{label}]"
    )
    require(loop_err == 0, "K4r's register-blocked route differs from its plain twin on s = 3 int32 codes")
    k4r_err = max(k4r_err, loop_err)
    del sc3, prep3, ab3, kc3, ab3_p, kc3_p

    # --- strobe goldens ------------------------------------------------------
    hits = kt.strobemer_find_genes(str(DATA / "Alp_V_locus.fasta"), REF, verbose=False, device=device)[0]
    require([h.description for h in hits] == GOLDEN_STROBE, f"Alp_V_locus strobe hits {[h.description for h in hits]}")
    print(f"strobe goldens: Alp_V_locus {len(hits)} hits equal the JAX package's [{label}]")

    # --- the strobe path at size ------------------------------------------------
    fasta, total_bp = ctx["fasta"], ctx["total_bp"]
    ctx["launches"].reset()
    times, out = timed_calls(
        lambda: kt.strobemer_find_genes(str(fasta), REF, verbose=False, do_return_hit_loci=True, device=device),
        sync, runs,
    )
    shits = out[0]
    ctx["uninterrupted"]["strobe"] = out
    slaunches = ctx["launches"].read()
    t_med = statistics.median(times)
    print(
        f"strobemer_find_genes {total_bp} bp ({len(contigs)} contigs): median of {runs} {t_med:.3f} s "
        f"= {total_bp / t_med / 1e6:.2f} Mbp/s (runs {', '.join(f'{x:.3f}' for x in times)} s), "
        f"{len(shits)} hits [{label}]"
    )
    t0 = time.perf_counter()
    soracle = strobe_mine_genome(str(fasta), profile, thr=thr, device_extract=False, device=device,
                                 engine_factory=HostStrobeOracle)
    print(f"int64 host strobe oracle (sorted-key window counts, all {len(contigs)} contigs): "
          f"{time.perf_counter() - t0:.3f} s, {len(soracle.hits)} hits [{label}]")
    strobe_stage_breakdown(fasta, profile, thr, t_med, sync, device, label, reps=runs)
    require(len(shits) > 0, "no strobe hits on the planted genome")
    require(
        [(h.description, h.seq) for h in shits] == [(h.description, h.seq) for h in soracle.hits],
        "strobemer_find_genes hits differ from the int64 host strobe oracle",
    )
    print(f"strobe hits equal the host oracle's; launch counts over the {runs + 1} runs: {slaunches}")
    if on_card:
        require(slaunches["codes_pair_ab_kcodes"] > 0 and slaunches["match_counts"] > 0,
                f"a kernel of the strobe path never launched: {slaunches}")
    return [
        entry("codes_pair_ab_kcodes[K4r]", "pair_depth.cu", "kmergma_tpu/ops/scan_pallas.py:329",
              slaunches["codes_pair_ab_kcodes"], k4r_err, k4r_ms, k4r_plain_ms, *k4r_io,
              s3={"bp": int(rec3.shape[0]), "depth": w3 - 1, "ms": float(loop_ms), "ms_min": loop_ms.min}),
    ]


class Dying:
    """An engine that raises ``KeyboardInterrupt`` when it is given record
    number ``left[0]`` (counting from 0) of a run: the run is killed there.
    ``left`` is one list shared by every engine of the run."""

    def __init__(self, inner, left: list):
        self.inner, self.left = inner, left

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _step(self) -> None:
        if self.left[0] == 0:
            raise KeyboardInterrupt("killed by chip_smoke")
        self.left[0] -= 1

    def record_stream(self, *args, **kwargs):
        self._step()
        return self.inner.record_stream(*args, **kwargs)

    def record_streams(self, *args, **kwargs):
        self._step()
        return self.inner.record_streams(*args, **kwargs)


def checkpoint_phase(ctx) -> None:
    """Each miner killed on its third record with ``checkpoint_path=`` and
    resumed on the card with its default engine: the resumed run must give
    the phase's uninterrupted API call's hits, sequences and loci, scan only
    the records left, run its path's kernels and remove the file.  Then
    ``find_genes`` resumes a killed single-profile run through the API."""
    import os

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.miner import mine_genome
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    profile, clusters = ctx["profile"], ctx["clusters"]
    cthrs = list(map(float, ctx["cthrs"]))
    sprofile = gen_strobe_ref_ws_cons(REF)

    def single(ckpt, left=None):
        p = profile
        engine = None if left is None else Dying(ScanEngine(p.sum_kfv, k=p.k, ws=p.windowsize, r=p.n_records, device=device), left)
        return mine_genome(str(ctx["fasta"]), p, thr=ctx["thr"], get_hit_loci=True, engine=engine,
                           checkpoint_path=ckpt, device=device)

    def cluster(ckpt, left=None):
        engine = None if left is None else Dying(ClusterScanEngine(clusters.profiles, k=6, device=device), left)
        return mine_genome_clusters(str(ctx["cluster_fasta"]), clusters.profiles, thr_vec=cthrs, buff=100,
                                    get_hit_loci=True, engine=engine, checkpoint_path=ckpt, device=device)

    def strobe(ckpt, left=None):
        factory = None if left is None else (lambda p, x: Dying(StrobeSpanEngine(p, x, device=device), left))
        return strobe_mine_genome(str(ctx["fasta"]), sprofile, thr=30, get_hit_loci=True, engine_factory=factory,
                                  checkpoint_path=ckpt, device=device)

    def killed(name, run, ckpt) -> tuple[float, int]:
        """(wall in s, bytes of the file) of a run killed on its third record."""
        sync()
        t0 = time.perf_counter()
        try:
            run(ckpt, [KILL_AT])
        except KeyboardInterrupt:
            pass
        else:
            raise SmokeFailure(f"the {name} run was not killed")
        sync()
        wall = time.perf_counter() - t0
        require(os.path.exists(ckpt), f"the killed {name} run left no checkpoint")
        with open(ckpt) as fh:
            next_record = json.load(fh)["next_record"]
        require(next_record == KILL_AT, f"the killed {name} run's checkpoint says next_record {next_record}")
        return wall, os.path.getsize(ckpt)

    kernels = {
        "single": ("fused_record_bitmaps", "match_counts"),
        "cluster": ("fused_cluster_record_bitmaps", "lookup_roundtrip", "codes_pair_multi", "match_counts"),
        "strobe": ("codes_pair_ab_kcodes", "match_counts"),
    }
    n_records = {"single": len(ctx["contigs"]), "cluster": len(ctx["contigs"]) + 1, "strobe": len(ctx["contigs"])}
    for name, run in (("single", single), ("cluster", cluster), ("strobe", strobe)):
        ckpt = str(ctx["tmp"] / f"{name}.ckpt")
        kill_s, n_bytes = killed(name, run, ckpt)
        ctx["launches"].reset()
        sync()
        t0 = time.perf_counter()
        res = run(ckpt)
        sync()
        resume_s = time.perf_counter() - t0
        launches = ctx["launches"].read()
        want_hits, want_loci = ctx["uninterrupted"][name]
        scanned = res.stats.records_scanned
        print(f"checkpoint {name}: killed on record {KILL_AT} after {kill_s:.3f} s, checkpoint {n_bytes} bytes; "
              f"resumed in {resume_s:.3f} s, {scanned} records scanned of {n_records[name]}, {len(res.hits)} hits; "
              f"launches {dict((k, launches[k]) for k in kernels[name])} [{label}]")
        require([(h.description, h.seq) for h in res.hits] == [(h.description, h.seq) for h in want_hits],
                f"the resumed {name} run's hits differ from the uninterrupted run's")
        require(res.hit_loci == want_loci, f"the resumed {name} run's loci differ from the uninterrupted run's")
        require(scanned == n_records[name] - KILL_AT, f"the resumed {name} run scanned {scanned} records")
        require(not os.path.exists(ckpt), f"the resumed {name} run left its checkpoint behind")
        if on_card:
            missing = [k for k in kernels[name] if launches[k] == 0]
            require(not missing, f"the resumed {name} run never launched {missing}: {launches}")

    # through the API: find_genes resumes a killed single-profile run
    ckpt = str(ctx["tmp"] / "api.ckpt")
    killed("single", single, ckpt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hits, loci = kt.find_genes(str(ctx["fasta"]), REF, verbose=False, do_return_hit_loci=True,
                                   checkpoint_path=ckpt, device=device)
    want_hits, want_loci = ctx["uninterrupted"]["single"]
    require([(h.description, h.seq) for h in hits] == [(h.description, h.seq) for h in want_hits] and loci == want_loci,
            "find_genes resumed from a checkpoint differs from the uninterrupted call")
    require(not os.path.exists(ckpt), "find_genes left its checkpoint behind")
    print(f"checkpoint api: find_genes resumed a run killed on record {KILL_AT}, {len(hits)} hits equal the "
          f"uninterrupted call's [{label}]")


def paired_spectrum_check(ctx) -> None:
    """``kmer_pair_count_device`` at k = 3: a whole contig on the device
    against the same function on the CPU, and a 4 kb slice against the
    O(n^2) host loop, with its time per call."""
    import numpy as np

    from kmergma_tpu_torch.ops.paired_kmers import kmer_pair_count, kmer_pair_count_device

    device, on_card, label = ctx["device"], ctx["on_card"], ctx["label"]
    record = ctx["contigs"][0]
    ms, got = kernel_ms(lambda: kmer_pair_count_device(record, 3, device=device), on_card, reps=5)
    cpu = kmer_pair_count_device(record, 3, device="cpu")
    err = float(np.abs(got - cpu).max())
    piece = record[:PAIRED_SLICE_BP]
    slice_err = float(np.abs(kmer_pair_count_device(piece, 3, device=device) - kmer_pair_count(piece, 3)).max())
    print(f"paired spectrum k = 3, {record.shape[0]} bp record on {device}: {ms:.3f} ms a call (fastest window "
          f"{ms.min:.3f}), max_abs_err {err} against the CPU; {PAIRED_SLICE_BP} bp slice max_abs_err {slice_err} "
          f"against the host loop; {int(got.sum())} pairs [{label}]")
    require(err == 0 and slice_err == 0, "the paired spectrum on the device differs")
    require(got.sum() == float(record.shape[0] - 2) ** 2, "the paired spectrum does not count every pair")


def mixed_depth_engine(clusters, cthrs, device, label: str):
    """(engine, profiles, thresholds) of the mixed-depth cluster set: the
    six Alp_V clusters plus a profile of the genes' 20 bp prefixes."""
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_threshold
    from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

    k = 6
    prefixes = gen_ref_ws_cons([FastaRecord(rec.description, rec.seq[:PREFIX_BP]) for rec in as_records(REF)], k)
    # the auto estimate's buffer of 7 exceeds the prefix profile's mean
    # random distance (the threshold would be negative); at buffer 0.8 it
    # lies above the prefix windows of most planted genes and below nearly
    # every window of the hashed background
    prefix_thr = estimate_optimal_threshold(prefixes.mean_kfv, prefixes.windowsize, buffer=0.8)
    profiles = [*clusters.profiles, prefixes]
    thrs = [*cthrs, prefix_thr]
    eng = ClusterScanEngine(profiles, k=k, device=device)
    groups = [(ws, depth) for ws, depth, _i, _r in eng.groups]
    print(f"mixed-depth cluster set: {len(profiles)} profiles, (windowsize, pair depth) groups {groups}, "
          f"prefix profile R {prefixes.n_records}, threshold {prefix_thr} [{label}]")
    require(not eng.one_depth and groups[0] == (PREFIX_BP, PREFIX_BP - k), f"groups {groups}")
    return eng, profiles, thrs


def mixed_depth_phase(ctx) -> list:
    """K4 and K6 against their twins at the split pass's shapes and at the
    single-profile width, then the mixed-depth set through
    ``ClusterScanEngine`` on a 16 Mbp contig and the short contig, its
    streams equal to the int64 host cluster oracle's."""
    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    contigs = ctx["contigs"]
    eng, profiles, thrs = mixed_depth_engine(ctx["clusters"], ctx["cthrs"], device, label)
    k = eng.k
    groups = [(ws, depth) for ws, depth, _i, _r in eng.groups]

    # --- K4 and K6 vs their twins --------------------------------------------
    record = contigs[0]
    results = pair_depth_measure(eng, record, on_card, label)

    # --- the mixed-depth set against the int64 host cluster oracle ----------
    oracle = HostClusterOracle(profiles, k)
    total = dict.fromkeys(ctx["launches"].wrappers, 0)
    for codes_r in (record, ctx["short_contig"]):
        n = codes_r.shape[0]
        ctx["launches"].reset()
        ms, got = clock(lambda: eng.record_streams(codes_r, thrs), sync)
        launches = ctx["launches"].read()
        total = {name: total[name] + n_l for name, n_l in launches.items()}
        require(got == oracle.minimal_streams(codes_r, thrs, eng.max_ws),
                f"mixed-depth cluster streams differ from the int64 host oracle on a {n} bp record")
        print(f"mixed-depth streams equal the int64 host oracle's on a {n} bp record ({ms:.3f} ms): "
              f"{[len(s) for _d0, s in got]} stream entries; launch counts {launches} [{label}]")
        require(len(got[-1][1]) > 0, "no prefix-profile stream entries on a record with planted genes")
        if on_card:
            require(launches["codes_pair_ab_kcodes"] == 1 and launches["pair_ab_from_kcodes"] == len(groups) - 1
                    and launches["match_counts"] > 0, f"the mixed-depth pass did not run K4, K6 and K2: {launches}")
    k4 = results[("K4", PREFIX_BP - k)]
    k6 = results[("K6", groups[1][1])]
    k6_prefix = results[("K6", PREFIX_BP - k)]
    return [
        entry("codes_pair_ab_kcodes[K4]", "pair_depth.cu", "kmergma_tpu/ops/scan_pallas.py:236",
              total["codes_pair_ab_kcodes"], max(v["err"] for (n_, _d), v in results.items() if n_ == "K4"),
              k4["ms"], k4["plain_ms"], *k4["io"], device_ms=k4["device_ms"]),
        entry("pair_ab_from_kcodes", "pair_depth.cu", "kmergma_tpu/ops/scan_pallas.py:75",
              total["pair_ab_from_kcodes"], max(v["err"] for (n_, _d), v in results.items() if n_ == "K6"),
              k6["ms"], k6["plain_ms"], *k6["io"], device_ms=k6["device_ms"],
              prefix_depth={"depth": PREFIX_BP - k, "ms": float(k6_prefix["ms"]), "ms_min": k6_prefix["ms"].min,
                            "device_ms": k6_prefix["device_ms"], "bound_ms": bound(*k6_prefix["io"])[0]}),
    ]


def k5_measure(ceng, record, n_bps, on_card: bool, label: str, time_plain: bool = True) -> dict:
    """K5 against its twin at the split pass's shapes on the first ``n_bp``
    bp of ``record`` for each of ``n_bps``: {n_bp: {ms, plain_ms, err, io,
    device_ms, shape}}, wrapper ms from ``kernel_ms``, device ms from
    ``queued_device_ms`` (on the card), the launch shape where the package
    reports it.  It calls only ``codes_pair_multi``, ``_pair_multi_need``
    and the engine's ``prepare_codes`` / ``_split_span``, so it times an
    earlier checkout too."""
    from kmergma_tpu_torch.ops import scan_kernels as sk

    k, depth = ceng.k, ceng.groups[0][1]
    ws_groups = tuple(g[0] for g in ceng.groups)
    max_w = max(ws_groups) - k + 1
    launch_shape = getattr(sk, "pair_multi_launch_shape", None)
    out = {}
    for n_bp in n_bps:
        pp = ceng.prepare_codes(record[:n_bp])
        span = ceng._split_span(n_bp - min(ws_groups) + 1)
        args = (pp, k, ws_groups, span - 1, span + max_w - 1, depth)
        ms, (ab, kc) = kernel_ms(lambda: sk.codes_pair_multi(*args), on_card)
        if time_plain:
            pms, (ab_p, kc_p) = kernel_ms(lambda: sk._codes_pair_multi_plain(*args), on_card, reps=3)
        else:
            pms, (ab_p, kc_p) = None, sk._codes_pair_multi_plain(*args)
        err = max_err((ab, ab_p), (kc, kc_p))
        io = (sk._pair_multi_need(ws_groups, span - 1, span + max_w - 1)[1]
              + 4 * (len(ws_groups) * (span - 1) + span + max_w - 1), 4 * depth * (span - 1))
        dev = queued_device_ms(lambda: sk.codes_pair_multi(*args)) if on_card else None
        shape = launch_shape(k, ws_groups, span - 1, span + max_w - 1) if launch_shape else None
        out[n_bp] = {"ms": ms, "plain_ms": pms, "err": err, "io": io, "device_ms": dev, "shape": shape}
        plain = "" if pms is None else f", plain twin {pms:.3f} ms"
        devs = "" if dev is None else f", device {dev:.5f} ms"
        print(f"K5 codes_pair_multi, {n_bp} bp record, span {span}, groups {ws_groups}, depth {depth}: {ms:.4f} ms "
              f"(fastest window {ms.min:.4f}){devs}{plain}, bound {bound(*io)[0]:.5f} ms ({bound(*io)[1]}), launch "
              f"{shape}, bit-identical={err == 0} [{label}]")
        require(err == 0, f"K5 differs from its plain twin on a {n_bp} bp record")
    return out


def device_by_name(call, reps: int = 20) -> tuple[dict, int]:
    """({kernel name: device ms per call}, device intervals per call) of
    ``reps`` calls of ``call`` under torch.profiler, after a first profiled
    call that only starts the tracer."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities):
        call()
    with torch_profile(activities=activities) as prof:
        torch.cuda.synchronize()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    totals: dict = {}
    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    for e in dev:
        totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return totals, len(dev) // reps


def split_pass_profile(profiles, k: int, codes, thrs, device, on_card: bool, label: str) -> dict:
    """One record's bitmap pass on both routes: the split pass (K5 and the
    torch glue after it) and K3's route (an engine copy with
    ``fused_min_windows = 0``), bitmaps equal over the record's blocks;
    wall ms a call from ``kernel_ms`` and, on the card, device ms by
    kernel from torch.profiler."""
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine

    split_eng = ClusterScanEngine(profiles, k=k, device=device)
    k3_eng = ClusterScanEngine(profiles, k=k, device=device)
    k3_eng.fused_min_windows = 0
    n = codes.shape[0]
    nws = [n - e.ws + 1 for e in split_eng.engines]
    thr_ints = [int(e._thr_int(x)) for e, x in zip(split_eng.engines, thrs)]
    prep = split_eng.prepare_codes(codes)
    routes = {"split": lambda: split_eng._split_bitmaps(prep, nws, thr_ints),
              "K3": lambda: k3_eng._fused_bitmaps(prep, nws, thr_ints)}
    bms = {name: call() for name, call in routes.items()}
    nb = -(-max(nws) // split_eng.block)
    a, b = bms["split"], bms["K3"]
    require(bool((a[:, :nb] == b[:, :nb]).all()) and not bool(a[:, nb:].any()) and not bool(b[:, nb:].any()),
            f"the split pass's and K3's bitmaps differ on a {n} bp record")
    out = {}
    for name, call in routes.items():
        ms, _ = kernel_ms(call, on_card, reps=10)
        row = {"wall_ms": float(ms), "wall_ms_min": ms.min}
        if on_card:
            totals, n_dev = device_by_name(call)
            kern = "pair_multi" if name == "split" else "fused_cluster"
            row["kernel_device_ms"] = sum(t for nm, t in totals.items() if kern in nm)
            row["glue_device_ms"] = sum(t for nm, t in totals.items() if kern not in nm)
            row["device_intervals"] = n_dev
        out[name] = row
    dev = {name: "" if "kernel_device_ms" not in r else
           f", device: kernel {r['kernel_device_ms']:.5f} ms + glue {r['glue_device_ms']:.5f} ms in "
           f"{r['device_intervals']} intervals" for name, r in out.items()}
    print(f"bitmap pass of one {n} bp record, bitmaps equal on both routes: split pass (K5 + glue) "
          f"{out['split']['wall_ms']:.4f} ms a call{dev['split']}; K3's route {out['K3']['wall_ms']:.4f} ms a "
          f"call{dev['K3']} [{label}]")
    return out


def fragmented_phase(ctx, short_contig) -> dict:
    """Cluster mode on a fragmented assembly: ``ClusterScanEngine
    .record_streams`` over ``ctx["fragments"]`` records of FRAGMENT_BP bp
    cut from the synthetic genome (the Alp_V set in six clusters, auto
    thresholds), one K5 launch a record, the first ORACLE_FRAGMENTS
    records' streams equal to the int64 host cluster oracle's; then one
    16 kb and one 60 kb bitmap pass on both routes
    (``split_pass_profile``)."""
    import numpy as np

    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    profiles, cthrs, k = ctx["clusters"].profiles, ctx["cthrs"], 6
    n_rec = ctx["fragments"]
    genome = np.concatenate(ctx["contigs"])
    require(genome.shape[0] >= n_rec * FRAGMENT_BP, f"the genome holds fewer than {n_rec} fragments")
    recs = genome[: n_rec * FRAGMENT_BP].reshape(n_rec, FRAGMENT_BP)
    n_oracle = min(ORACLE_FRAGMENTS, n_rec)
    eng = ClusterScanEngine(profiles, k=k, device=device)
    for r in recs[:8]:  # warm-up
        eng.record_streams(r, cthrs)
    ctx["launches"].reset()
    wall_s, streams = clock(lambda: [eng.record_streams(r, cthrs) for r in recs], sync)
    wall_s /= 1e3
    launches = ctx["launches"].read()
    mbps = n_rec * FRAGMENT_BP / wall_s / 1e6
    print(f"fragmented assembly: {n_rec} records of {FRAGMENT_BP} bp through ClusterScanEngine.record_streams: "
          f"{wall_s:.3f} s = {mbps:.2f} Mbp/s, {sum(len(s) for st in streams for _d, s in st)} stream entries; "
          f"launch counts {launches} [{label}]")
    if on_card:
        require(launches["codes_pair_multi"] == n_rec and launches["fused_cluster_record_bitmaps"] == 0,
                f"the fragmented records did not take K5 once each: {launches}")
    oracle = HostClusterOracle(profiles, k)
    for i in range(n_oracle):
        require(streams[i] == oracle.minimal_streams(recs[i], cthrs, eng.max_ws),
                f"fragment {i}'s cluster streams differ from the int64 host oracle")
    require(any(s for st in streams for _d, s in st), "no cluster stream entries on the fragmented genome")
    print(f"the first {n_oracle} fragments' streams equal the int64 host cluster oracle's [{label}]")
    device_share(f"{n_oracle}-fragment record_streams",
                 lambda: [eng.record_streams(r, cthrs) for r in recs[:n_oracle]], sync, device, label)
    passes = {str(n_bp): split_pass_profile(profiles, k, codes, cthrs, device, on_card, label)
              for n_bp, codes in ((FRAGMENT_BP, recs[0]), (SHORT_CONTIG_BP, short_contig))}
    return {"records": n_rec, "record_bp": FRAGMENT_BP, "wall_s": wall_s, "mbps": mbps,
            "k5_launches": launches["codes_pair_multi"], "bitmap_pass": passes}


def pair_depth_measure(eng, record, on_card: bool, label: str) -> dict:
    """K4 and K6 against their twins at the mixed-depth split pass's shapes
    on ``record`` (K4 at the prefix group's width and depth and at the
    single-profile width and depth 16; K6 at the second group's width and
    depth and at the prefix group's): {(name, depth): {ms, plain_ms, err,
    io, device_ms}}, wrapper ms from ``kernel_ms``, device ms from
    ``queued_device_ms`` (on the card)."""
    from kmergma_tpu_torch.ops.scan import _pair_ab
    from kmergma_tpu_torch.ops.scan_kernels import (
        _codes_pair_ab_kcodes_plain, _pair_depth_need, codes_pair_ab_kcodes, pair_ab_from_kcodes,
    )

    k = eng.k
    groups = [(ws, depth) for ws, depth, _i, _r in eng.groups]
    prep = eng.prepare_codes(record)
    span = eng._split_span(record.shape[0] - PREFIX_BP + 1)
    max_w = eng.max_ws - k + 1
    nt, nkc = span - 1, span + max_w - 1
    results = {}
    for name, w, depth in (("K4", PREFIX_BP - k + 1, PREFIX_BP - k), ("K4", 289 - k + 1, 16)):
        args = (prep, k, w, nt, nkc, depth)
        ms, (ab, kc) = kernel_ms(lambda: codes_pair_ab_kcodes(*args), on_card)
        pms, (ab_p, kc_p) = kernel_ms(lambda: _codes_pair_ab_kcodes_plain(*args), on_card, reps=1)
        io = (_pair_depth_need(k, w, nt, nkc)[1] + 4 * (nt + nkc), 4 * depth * nt)
        dev = queued_device_ms(lambda: codes_pair_ab_kcodes(*args)) if on_card else None
        results[(name, depth)] = {"ms": ms, "plain_ms": pms, "err": max_err((ab, ab_p), (kc, kc_p)), "io": io,
                                  "device_ms": dev}
    kcodes = kc
    for w_g, depth in ((groups[1][0] - k + 1, groups[1][1]), (PREFIX_BP - k + 1, PREFIX_BP - k)):
        kc_g = kcodes[: nt + w_g]
        ms, ab6 = kernel_ms(lambda: pair_ab_from_kcodes(kc_g, w_g, nt, depth), on_card)
        pms, ab6_p = kernel_ms(lambda: _pair_ab(kc_g, w_g, nt, depth), on_card, reps=1)
        io = (4 * (nt + w_g) + 4 * nt, 4 * depth * nt)
        dev = queued_device_ms(lambda: pair_ab_from_kcodes(kc_g, w_g, nt, depth)) if on_card else None
        results[("K6", depth)] = {"ms": ms, "plain_ms": pms, "err": max_err((ab6, ab6_p)), "io": io, "device_ms": dev}
    for (name, depth), v in results.items():
        dev = "" if v["device_ms"] is None else f", device {v['device_ms']:.5f} ms"
        print(f"{name} at depth {depth}, k {k}, {nt} transitions of a {record.shape[0]} bp record: {v['ms']:.4f} ms "
              f"(fastest window {v['ms'].min:.4f}){dev}, plain twin {v['plain_ms']:.3f} ms, bound "
              f"{bound(*v['io'])[0]:.4f} ms ({bound(*v['io'])[1]}), bit-identical={v['err'] == 0} [{label}]")
        require(v["err"] == 0, f"{name} at depth {depth} differs from its plain twin")
    return results


def k1_twin_err(engine, codes, thr: float) -> tuple[int, int]:
    """(max abs error, active blocks) of K1 against its plain twin on one
    record's codes (a device tensor) at the engine's shapes."""
    from kmergma_tpu_torch.ops.scan import _first_window_l0
    from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps, fused_record_bitmaps_plain

    nw = codes.shape[0] - engine.ws + 1
    prep = engine.prepare_codes(codes)
    depth = engine.bound_depth
    l0 = _first_window_l0(prep, engine.s_dev, k=engine.k, ws=engine.ws, r=engine.r, depth=depth)
    args = (prep, engine.s_dev, int(engine._thr_int(thr)), l0, nw)
    kw = dict(k=engine.k, ws=engine.ws, r=engine.r, depth=depth, t=engine.fused_t, block=engine.block,
              n_tiles=-(-nw // engine.fused_t))
    bm = fused_record_bitmaps(*args, **kw)
    return max_err((bm, fused_record_bitmaps_plain(*args, **kw))), int(bm.sum())


def k3_stage_ms(args: dict, l0s, reps: int = 20) -> list:
    """Median device ms of K3's pass 1, the tile-base scan and pass 2 over
    ``reps`` calls, CUDA events around each stage (on the card); ``args``
    from ``_k3_args`` (K3) or ``_k1_args`` (K1, K3's kernel at m = 1)."""
    import torch

    from kmergma_tpu_torch.ops.scan_cluster_fused import _k3_bitmap, _k3_tile_bases, _k3_totals

    totals, counts = _k3_totals(args)
    _k3_bitmap(args, _k3_tile_bases(totals, l0s)[0], counts)
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(reps)]
    for ev in events:
        ev[0].record()
        totals, counts = _k3_totals(args)
        ev[1].record()
        bases, _fits = _k3_tile_bases(totals, l0s)
        ev[2].record()
        _k3_bitmap(args, bases, counts)
        ev[3].record()
    torch.cuda.synchronize()
    return [statistics.median(ev[i].elapsed_time(ev[i + 1]) for ev in events) for i in range(3)]


def device_ms_per_call(call, reps: int = 20) -> tuple[float, str]:
    """(device ms per call, kernel names) of ``reps`` calls of ``call`` under
    torch.profiler, after a first profiled call that only starts the
    tracer: the sum of the device intervals over ``reps`` (as
    ``device_share`` reads them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities):
        call()
    with torch_profile(activities=activities) as prof:
        torch.cuda.synchronize()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    names = sorted({e.name[:60] for e in dev}) or ["no device interval recorded"]
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3, "; ".join(names)


def queued_device_ms(call, reps: int = 20) -> float:
    """Device ms per call of ``call``, with CUDA events around ``reps`` calls
    queued behind a spin of the card (``torch.cuda._sleep``, about 5 ms),
    so the card runs them back to back and no host time enters the
    interval.  For calls that do not synchronise."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k3_twin_err(ceng, codes, thrs) -> tuple[int, int]:
    """(max abs error, active blocks) of K3 against its plain twin on one
    record's codes (a device tensor) at the cluster engine's shapes."""
    import torch

    from kmergma_tpu_torch.ops.scan import _first_window_l0
    from kmergma_tpu_torch.ops.scan_cluster_fused import fused_cluster_record_bitmaps, fused_cluster_record_bitmaps_plain

    nws = [codes.shape[0] - ws_c + 1 for ws_c, _r in ceng.specs]
    prep = ceng.prepare_codes(codes)
    depth = ceng.groups[0][1]
    l0s = torch.stack([_first_window_l0(prep, e.s_dev, k=ceng.k, ws=e.ws, r=e.r, depth=depth) for e in ceng.engines])
    args = (prep, ceng.s_stack, [int(e._thr_int(x)) for e, x in zip(ceng.engines, thrs)], l0s, nws)
    kw = dict(k=ceng.k, specs=ceng.specs, depth=depth, t=ceng.fused_t, block=ceng.block,
              n_tiles=-(-max(nws) // ceng.fused_t))
    bm = fused_cluster_record_bitmaps(*args, **kw)
    return max_err((bm, fused_cluster_record_bitmaps_plain(*args, **kw))), int(bm.sum())


def host_record_check(host, codes, thr: float, d0: float, stream: list, hits: list, what: str) -> int:
    """Hold one record's (dist0, stream, hits) from the card against the
    int64 host engine over the whole record: dist0 equal, every stream
    entry equal to the exact distance of its window, and the hits equal to
    the replay of the host's full stream.  Returns the host's stream
    length."""
    import numpy as np

    from kmergma_tpu_torch.models.state_machine import replay_single

    n = codes.shape[0]
    hd0, hstream, hdists = host.record_stream(codes.cpu().numpy(), thr, collect_dists=True)
    idx = np.array([i for i, _d in stream], dtype=np.int64)
    exact = np.array_equal(hdists[idx], np.array([d for _i, d in stream], dtype=np.float64))
    want = replay_single(hstream, hd0, thr, host.k, host.ws, n, 50)
    require(d0 == hd0 and exact and hits == want,
            f"{what}: dist0 {d0} (host {hd0}), stream exact={exact}, {len(hits)} hits (host {len(want)})")
    return len(hstream)


def bench_phase(ctx) -> list:
    """The port's throughput harness (``kmergma_tpu_torch.bench.run``) at
    the sizes of ``ctx["bench_sizes"]``, then every row held against an
    independent reference at the row's own sizes: K7 against its twin over
    the whole headline genome; K1 against its twin on the headline (in
    64 Mbp pieces), hit-dense and k = 10 genomes, and K3 on the dense
    genome; the headline, k = 10 and 3.2 Gbp rows' dist0, streams and hits
    against the int64 host engine over each whole record; the dense row's
    hits against ``mine_genome`` on that engine, and k = 10 on a planted
    record too; the cluster streams against the int64 host cluster oracle
    and against the same engine fed from the host; the strobe hits against
    the int64 host strobe oracle and against the call without
    ``genome_dev=`` / ``engine_cache=``."""
    import numpy as np
    import torch

    from kmergma_tpu_torch import bench
    from kmergma_tpu_torch.models.miner import fmt_dist, mine_genome
    from kmergma_tpu_torch.models.state_machine import replay_single
    from kmergma_tpu_torch.models.strobe_miner import strobe_mine_genome
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_host import HostScanEngine
    from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    sizes = ctx["bench_sizes"]
    piece = 64_000_000  # bp per K7 / K1 twin comparison on the headline genome

    # --- the harness, every row ---------------------------------------------
    arts: dict = {}
    ctx["launches"].reset()
    t0 = time.perf_counter()
    result = bench.run(device, artefacts=arts, note=lambda msg: print(f"bench {msg} [{label}]", flush=True), **sizes)
    wall = time.perf_counter() - t0
    launches = ctx["launches"].read()
    peak = f"{torch.cuda.max_memory_allocated()} bytes" if on_card else "not measured (CPU)"
    print(f"bench json: {json.dumps(result)}")
    print(f"bench: one bench.run of every row {wall:.3f} s; peak device memory allocated in the 3.2 Gbp row {peak}; "
          f"launch counts {launches} [{label}]")
    require(tuple(result) == bench.KEYS, f"bench keys {list(result)}")
    if on_card:
        missing = [n for n in ("hash_genome", "fused_record_bitmaps", "match_counts", "fused_cluster_record_bitmaps",
                               "lookup_roundtrip", "codes_pair_ab_kcodes") if launches[n] == 0]
        require(not missing, f"a kernel of the bench path never launched: {launches}")

    # --- K7 vs its plain twin over the headline genome -------------------------
    n_head = int(sizes["n_mbp"] * 1e6)
    k7_ms, genome = kernel_ms(lambda: bench.hash_genome(n_head, 42, device), on_card)
    k7_plain_ms, genome_plain = kernel_ms(lambda: bench.hash_genome_plain(n_head, 42, device, piece=piece), on_card, reps=3)
    k7_err = max_err((genome, genome_plain))
    head = min(n_head, 4_000_000)
    np_ok = np.array_equal(genome[:head].cpu().numpy(), hash_codes(head, 0, seed=42))
    k7_io = (n_head, 10 * n_head)  # one byte written per code; ~10 integer operations per code
    print(f"K7 hash_genome, {n_head} codes (seed 42): {k7_ms:.3f} ms, plain twin in 64 Mbp pieces {k7_plain_ms:.3f} ms, "
          f"bound {bound(*k7_io)[0]:.4f} ms ({bound(*k7_io)[1]}), bit-identical={k7_err == 0}, "
          f"first {head} codes equal to numpy hash_codes={np_ok} [{label}]")
    require(k7_err == 0 and np_ok, "K7 differs from its plain twin or from numpy hash_codes")
    del genome_plain

    # --- the headline row: K1 vs its twin, the row against the host engine ----
    dense = arts["dense"]
    p = dense["profile"]
    eng = ScanEngine(p.sum_kfv, k=p.k, ws=p.windowsize, r=p.n_records, device=device)
    host = HostScanEngine(p.sum_kfv, k=p.k, ws=p.windowsize, r=p.n_records)
    rnd = arts["random"]
    k1 = [k1_twin_err(eng, genome[s : s + piece + p.windowsize - 1], rnd["thr"])
          for s in range(0, n_head - p.windowsize + 1, piece)]
    require(all(err == 0 for err, _a in k1), "K1 differs from its plain twin on the headline genome")
    t0 = time.perf_counter()
    n_host = host_record_check(host, genome, rnd["thr"], rnd["dist0"], rnd["stream"], rnd["hits"], "bench headline")
    print(f"bench headline: K1 bit-identical to its twin in {len(k1)} pieces of at most {piece} bp (active blocks "
          f"{[a for _e, a in k1]}); dist0, {len(rnd['stream'])} stream entries and {len(rnd['hits'])} hits equal the "
          f"int64 host engine's over the whole record ({n_host} host stream entries, "
          f"{time.perf_counter() - t0:.3f} s) [{label}]")

    # --- the device's busy share of the headline and hit-dense rows ----------
    device_share(f"bench headline row ({n_head} bp, record_stream)", lambda: eng.record_stream(genome, rnd["thr"]),
                 sync, device, label)
    dgenome = torch.from_numpy(dense["codes"]).to(device)

    def dense_row():
        d0, st, _ = eng.record_stream(dgenome, dense["thr"])
        return replay_single(st, d0, dense["thr"], p.k, p.windowsize, dgenome.shape[0], 50)

    device_share(f"bench hit-dense row ({dgenome.shape[0]} bp, record_stream + replay)", dense_row, sync, device, label)
    del genome

    # --- the dense row: K1 vs its twin, hits against the int64 host engine ----
    codes = dense["codes"]
    k1_err, k1_active = k1_twin_err(eng, dgenome, dense["thr"])
    rec = FastaRecord("bench_dense", np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes(), _codes=codes)
    t0 = time.perf_counter()
    oracle = mine_genome([rec], p, thr=dense["thr"], do_align=False, engine=host)
    got = [f"bench_dense | dist = {fmt_dist(h.dist)} | MatchPos = {h.start}:{h.stop} | GenomePos = 0 | Len = {h.stop - h.start + 1}"
           for h in dense["hits"]]
    require(k1_err == 0, "K1 differs from its plain twin on the hit-dense genome")
    require(got == [h.description for h in oracle.hits], "the hit-dense row's hits differ from the int64 host engine's")
    print(f"bench hit-dense: K1 bit-identical to its twin ({k1_active} active blocks); {len(got)} hits equal "
          f"mine_genome's on the int64 host engine ({time.perf_counter() - t0:.3f} s) [{label}]")

    # --- the k = 10 row, then k = 10 on a planted record ----------------------
    r10 = arts["k10"]
    p10 = r10["profile"]
    e10 = ScanEngine(p10.sum_kfv, k=10, ws=p10.windowsize, r=p10.n_records, device=device)
    h10 = HostScanEngine(p10.sum_kfv, k=10, ws=p10.windowsize, r=p10.n_records)
    n10 = int(sizes["k10_mbp"] * 1e6)
    g10 = bench._device_random_genome(n10, 17, device)
    k1_err, k1_active = k1_twin_err(e10, g10, r10["thr"])
    require(k1_err == 0, "K1 differs from its plain twin on the k = 10 genome")
    hits10 = replay_single(r10["stream"], r10["dist0"], r10["thr"], 10, p10.windowsize, n10, 50)
    n_host = host_record_check(h10, g10, r10["thr"], r10["dist0"], r10["stream"], hits10, "bench k=10 row")
    print(f"bench k=10 row: K1 (4^10 bins) bit-identical to its twin on {n10} bp ({k1_active} active blocks); dist0, "
          f"{len(r10['stream'])} stream entries and {len(hits10)} hits equal the int64 host engine's ({n_host} host "
          f"stream entries) [{label}]")
    del g10
    n10 = ctx["whole_bp"]
    g10, n_planted = bench._plant_genes_device(bench._device_random_genome(n10, 17, device), as_records(REF), n10, n10 // 20)
    d0, st, _ = e10.record_stream(g10, 8.0)
    hits10 = replay_single(st, d0, 8.0, 10, p10.windowsize, n10, 50)
    host_record_check(h10, g10, 8.0, d0, st, hits10, "k = 10 on a planted record")
    require(len(hits10) > 0, "k = 10 found no hit on a planted record")
    print(f"bench k=10: {n10} bp record with {n_planted} planted genes, dist0 {d0}, {len(hits10)} hits, equal to the "
          f"int64 host engine's [{label}]")
    del g10

    # --- the cluster row: K3 vs its twin, streams against the oracles ---------
    cl = arts["cluster"]
    ceng = cl["engine"]
    k3_err, k3_active = k3_twin_err(ceng, dgenome, cl["thrs"])
    require(k3_err == 0, "K3 differs from its plain twin on the hit-dense genome")
    t0 = time.perf_counter()
    want = HostClusterOracle(cl["profiles"], ceng.k).minimal_streams(codes, cl["thrs"], ceng.max_ws)
    require(cl["pairs"] == want, "the cluster row's streams differ from the int64 host cluster oracle's")
    require(cl["pairs"] == ceng.record_streams(codes, cl["thrs"]),
            "the cluster row's streams differ from the same engine's on the genome shipped from the host")
    print(f"bench cluster: K3 bit-identical to its twin ({k3_active} active blocks); streams on the resident genome "
          f"equal the int64 host cluster oracle's ({time.perf_counter() - t0:.3f} s) and those on its host copy "
          f"({[len(s) for _d0, s in cl['pairs']]} entries) [{label}]")
    del dgenome

    # --- the strobe row: hits against the int64 host strobe oracle -------------
    sr = arts["strobe"]
    t0 = time.perf_counter()
    soracle = strobe_mine_genome([sr["record"]], sr["profile"], thr=sr["thr"], do_align=False, device_extract=False,
                                 device=device, engine_factory=HostStrobeOracle)
    require(sr["hits"] == [(h.description, h.seq) for h in soracle.hits],
            "the strobe row's hits differ from the int64 host strobe oracle's")
    plain = strobe_mine_genome([sr["record"]], sr["profile"], thr=sr["thr"], do_align=False, device=device)
    require(sr["hits"] == [(h.description, h.seq) for h in plain.hits],
            "the strobe row's hits differ from the call without genome_dev= and engine_cache=")
    print(f"bench strobe: {len(sr['hits'])} hits equal the int64 host strobe oracle's ({time.perf_counter() - t0:.3f} s) "
          f"and the call without genome_dev= and engine_cache= [{label}]")

    # --- the 3.2 Gbp row against the int64 host engine, record by record -------
    g3 = arts["g3"]
    thr, n_found = dense["thr"], 0
    t0 = time.perf_counter()
    for ri, (gen, (d0, stream, hits)) in enumerate(zip(g3["genomes"], g3["records"])):
        host_record_check(host, gen, thr, d0, stream, hits, f"3.2 Gbp record {ri}")
        n_found += sum(any(h.start - 1 <= q < h.stop for h in hits) for q in g3["planted"])
    require(len(set(g3["counts"])) == 1, f"3.2 Gbp repeats disagree: (candidates, hits) {g3['counts']}")
    print(f"bench 3.2 Gbp: {len(g3['records'])} records, dist0, streams and hits equal the int64 host engine's over "
          f"each whole record ({time.perf_counter() - t0:.3f} s); {n_found} of "
          f"{len(g3['records']) * len(g3['planted'])} genes start inside a hit; (candidates, hits) per repeat "
          f"{g3['counts']}; peak device memory allocated in the row {peak} [{label}]")
    return [
        entry("hash_genome", "hash_genome.cu", "bench.py:139", launches["hash_genome"], k7_err, k7_ms, k7_plain_ms, *k7_io),
    ]


def build_kernels(label: str) -> None:
    """Build (or load) the kernel library, printing the build time and
    ptxas's registers and spills per kernel."""
    from kmergma_tpu_torch import _kernels

    lib_path, log_path = _kernels.paths()
    built = not lib_path.exists()
    t0 = time.perf_counter()
    _kernels.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (compiled now: {built}, {lib_path}) [{label}]")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def pair_kernels(device, label: str = "", contig_bp: int = 16_000_000, whole_bp: int = 4_000_000) -> dict:
    """K2, K4, K6 and K5 alone at the shapes the main paths give them
    (``python3 chip_smoke.py --pair-kernels``): the first contig of the
    synthetic genome, K1's bitmap over it for K2's region rows, the
    whole-record scan's rows, the mixed-depth split pass's K4 and K6
    shapes, and the cluster split pass's K5 on its first 60 kb, 16 kb and
    ``whole_bp``, each against its plain twin.  It calls only the package's
    public wrappers and engines, so the same script times an earlier
    checkout of the package: run from a copy of this file placed in that
    checkout's root.  Returns {shape: {ms, ms_min, device_ms}}."""
    import torch

    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine, _first_window_l0
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_threshold, estimate_optimal_thresholds
    from kmergma_tpu_torch.utils.fasta import as_records

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        build_kernels(label)
    profile = gen_ref_ws_cons(REF, 6)
    record = synthetic_genome(1, contig_bp, 500_000, [rec.codes for rec in as_records(REF)])[0]
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    thr = estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0)
    nw = record.shape[0] - ws + 1
    prep = engine.prepare_codes(record)
    depth = engine.bound_depth
    l0 = _first_window_l0(prep, engine.s_dev, k=k, ws=ws, r=r, depth=depth)
    bm = fused_record_bitmaps(prep, engine.s_dev, int(engine._thr_int(thr)), l0, nw, k=k, ws=ws, r=r, depth=depth,
                              t=engine.fused_t, block=engine.block, n_tiles=-(-nw // engine.fused_t))
    k2 = k2_measure(engine, prep, bm, nw, whole_bp, on_card, label)
    clusters = eliminate_null_params(cluster_ref_api(REF, 6))
    cthrs = estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0)
    eng, _profiles, _thrs = mixed_depth_engine(clusters, cthrs, device, label)
    out = {
        "K2_region_rows": {"ms": float(k2["ms"]), "ms_min": k2["ms"].min, "device_ms": k2["device_ms"]},
        "K2_whole_record": {key: k2["whole"][key] for key in ("ms", "ms_min", "device_ms")},
    }
    for (name, d), v in pair_depth_measure(eng, record, on_card, label).items():
        out[f"{name}_depth{d}"] = {"ms": float(v["ms"]), "ms_min": v["ms"].min, "device_ms": v["device_ms"]}
    ceng = ClusterScanEngine(clusters.profiles, k=6, device=device)
    for n_bp, v in k5_measure(ceng, record, (SHORT_CONTIG_BP, FRAGMENT_BP, whole_bp), on_card, label, time_plain=False).items():
        out[f"K5_{n_bp}bp"] = {"ms": float(v["ms"]), "ms_min": v["ms"].min, "device_ms": v["device_ms"]}
    return out


def run(device, contig_bp: int = 16_000_000, n_contigs: int = 4, plant_every: int = 500_000, whole_bp: int = 4_000_000, runs: int = 3, label: str = "", bench_sizes: dict | None = None, fragments: int = FRAGMENTS) -> dict:
    """All phases on ``device``; raises SmokeFailure on any failed check.
    ``runs`` timed runs follow one warm-up at size, and each stage of the
    breakdowns is the median of ``runs``; ``bench_sizes`` are the bench
    phase's row sizes (``BENCH_SIZES`` by default), ``fragments`` the
    fragmented assembly's record count.  Returns the kernels' report."""
    import torch

    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_threshold, estimate_optimal_thresholds
    from kmergma_tpu_torch.utils.fasta import as_records

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    if on_card:
        build_kernels(label)

    profile = gen_ref_ws_cons(REF, 6)
    genes = [rec.codes for rec in as_records(REF)]
    contigs = synthetic_genome(n_contigs, contig_bp, plant_every, genes)
    # the cluster path's short contig (hashed background, seed 1, three genes)
    short_contig = hash_codes(SHORT_CONTIG_BP, n_contigs * contig_bp, seed=1)
    for j, pos in enumerate(range(10_000, SHORT_CONTIG_BP - 1_000, 20_000)):
        short_contig[pos : pos + genes[j].shape[0]] = genes[j]
    clusters = eliminate_null_params(cluster_ref_api(REF, 6))
    ctx = dict(
        device=device, on_card=on_card, sync=sync, label=label, runs=runs, whole_bp=whole_bp,
        profile=profile, thr=estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0),
        contigs=contigs, short_contig=short_contig, total_bp=sum(c.shape[0] for c in contigs),
        clusters=clusters, cthrs=estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0),
        launches=Launches(), bench_sizes=BENCH_SIZES if bench_sizes is None else bench_sizes, fragments=fragments,
    )
    with tempfile.TemporaryDirectory() as tmp:
        ctx.update(tmp=Path(tmp), fasta=Path(tmp) / "genome.fasta", cluster_fasta=Path(tmp) / "cluster_genome.fasta",
                   uninterrupted={})
        write_fasta(ctx["fasta"], contigs)
        kernels = single_profile_phase(ctx) + cluster_phase(ctx) + strobe_phase(ctx)
        checkpoint_phase(ctx)
    paired_spectrum_check(ctx)
    kernels += mixed_depth_phase(ctx)
    kernels += bench_phase(ctx)
    return {"kernels": kernels}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        from kmergma_tpu_torch.bench import card_label
    except ImportError:
        print("chip_smoke: the package kmergma_tpu_torch is not beside this script; run it from a checkout of the "
              "repository", file=sys.stderr)
        return 1

    label = card_label()
    print(f"card: {label}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    try:
        if sys.argv[1:] == ["--pair-kernels"]:
            print(json.dumps({"pair_kernels": pair_kernels("cuda", label=label)}))
            print(f"card: {label}")
            return 0
        report = run("cuda", label=label)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report))
    print(f"card: {label}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
