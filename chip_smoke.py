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
  int64 host oracle;
* cluster mode (the Alp_V set in six clusters): K3, K8 and K5 against
  their twins (K3 also per stage with its grid, and on the ``__ldg`` route
  over the same contig at k = 7; K8's device time from torch.profiler and
  from calls queued behind a spin, beside ``index_select``'s), the cluster
  goldens through ``find_genes_cluster_mode``
  (the split route, so K5), both routes on one record, then the same
  genome plus one short contig (the split route again) mined against an
  int64 host cluster oracle; K5 with its
  device time and launch shape on 60 kb, 16 kb and 4 Mbp records; then a
  fragmented assembly (1,024 records of 16 kb, 16.4 Mbp, each on the
  split route) through ``ClusterScanEngine.record_streams``, the first 64
  records against the int64 host cluster oracle, and one 16 kb and one
  60 kb bitmap pass on both routes: K5's device time against the torch
  glue after it, and K3's route on the same record;
* many clusters (cluster mode past the 32 profiles one K3 or K8 call
  takes): ``find_genes_cluster_mode`` on Loci.fasta with 35
  clusters against the port's CPU path, then 84 clusters through
  ``ClusterScanEngine`` on the first contig (K3 on three groups of at most
  32 clusters: six launches) and the short contig (the split pass), the
  streams against the int64 host cluster oracle; R1's calls and kernel
  launches a planned pass (one launch a call);
* strobemers (the Alp_V strobe profile, s 2, w_min 3, w_max 5, q 5): K4r
  (K4 at depth ws - k = 282 over uint8 strobe codes, codes >= 128 present:
  the sliding-histogram route) against its twin, and its depth-loop route
  on int32 strobe codes at s = 3, the strobe goldens through ``strobemer_find_genes``,
  then the same genome mined against an int64 host oracle of the strobe
  recurrence;
* R1, the planned record's run reduce (``run_reduce_multi``: the below
  mask and the segmented (min, first-argmin) scan of every profile of a
  planned pass in one call): its launches in each path's run (one call a
  planned pass, all clusters in it; one kernel launch a call), then
  against its plain twin, the torch chain it replaced, on the inputs
  captured from a planned pass of the single-profile, cluster,
  fragmented, strobe and many-clusters (m = 35, 84) cells' calls (wrapper
  and device times beside the chain's) and on the edge cases of
  ``tests/_r1_cases.py`` (33 and 84 profiles among them);
* the device aligner: A1 (``align_dp``, ``align_cigar``) against its
  plain twins on the card (scores, JAX runs, run counts, endpoints, CIGAR
  runs, their counts) on the windows the single-profile and strobe API
  calls hand their aligner and on 1,024 windows cut around the planted
  genes, then on a subject past 511 letters, one past the shared-memory
  budget (decisions in device memory), a query past one strip, m = 0 and
  n = 0; its AlignResults against the native DP's, ``find_genes`` and
  ``strobemer_find_genes`` by default (A1 launched on the card) against
  their runs under ``KMERGMA_ALIGN_DEVICE=0``, the host DP; A1's time
  beside its first design's, its launch shape (registers, shared memory,
  blocks an SM), the stages of ``semiglobal_align_device`` and the native
  DP's time for one window and on 1-8 threads;
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
* long records and shards: one 512 Mbp record of host codes (hashed
  background, the genes planted every 6 Mbp and one across the first
  segment boundary) on the segmented path (8 segments at the default
  ``chunk_windows``) against the one-pass path on the same codes as a
  device tensor and against the int64 host engine over the whole record,
  each path's peak device memory, wall and K1 and K2 launches;
  ``mine_genome`` on it killed after 3 segments and resumed (only the 5
  remaining scanned, the uninterrupted hits, the file removed); the
  sharded engines over 1 and 4 logical shards of the first card on the
  genome's contigs and the short contig, equal to the one-device engines
  (K1, K2, K3, K5, K8); ``find_genes(devices=1)`` and
  ``find_genes_cluster_mode(devices=1)`` equal to the API phases' hits; a
  one-rank NCCL group through ``initialize_distributed`` around one
  sharded pass; ``devices=2`` where a second card is present; and the
  checkpoint's cost on 256 fragments of the fragmented assembly;
* the profile-sharded engine: ``TPScanEngine`` over 1 and 4 logical
  shards of the first card at k = 10 and 12 on one 16 Mbp contig against
  the one-device ``ScanEngine`` and the int64 host engine (K6 and K2
  launched, K1 not; walls and table bytes a device), over four cards
  with the miners' own route to it where four are present, and
  ``ScanEngine`` at k = 15 against it;
* the two-axis step: ``sharded_cluster_scan_step`` on the first 16 Mbp
  contig in 245 tiles of 65,536 windows (``make_tiles``) against four
  profiles (each a fourth of the reference set), at a threshold that lets
  about one window in 10,000 below and at 2^30 (every buffer full), on the
  (1 x 1), (1 x 4), (2 x 2) and (4 x 1) ("clusters" x "data") meshes over
  logical shards of the first card: all six outputs against the int64
  host engine's distances cut per tile, K2 launched once a device and K1
  and K3 not, walls, device times and peak memory; K2 against its twin at
  the step's shape; a (2 x 1) hybrid mesh over a one-rank NCCL group;
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
  oracle; with the 3.2 Gbp row's peak device memory.

Each path's kernels are shown to have launched in that path's run: their
launch counts are set to 0 just before it and read just after.  Kernel
times are CUDA events over back-to-back launches after a warm-up, the
median of five windows with the fastest beside it.

``python3 chip_smoke.py --pair-kernels`` times K2, K4, K6 and K5 alone
at those shapes, then the planned pass's engine calls (single, cluster,
strobe and 64 fragments: wall and device ms) and R1 alone on their
inputs (one JSON line); a copy of
this file placed in the root of an earlier checkout times that
checkout's kernels the same way.  It is the parent-against-change tool
of the pair kernels' redesigns and of R1.
``python3 chip_smoke.py --r1-alone`` builds the kernels (ptxas's lines
printed) and times R1 alone on captured planned passes at m = 1, 6, a
fragment's 6, 35 and 84 (one JSON line); run from a copy of the
checkout with another build of R1, it compares the two.
``python3 chip_smoke.py --tp-cards`` runs the profile-sharded engine's
phase alone, on a host with four cards; ``--mesh-cards`` the two-axis
step's phase alone there, its four-device meshes over the four cards.  No
other option is taken.

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
#: the long-record phase's record: 512 Mbp of host codes, 8 segments at the
#: engine's default chunk_windows
LONG_BP = 512_000_000
#: the reference gene planted across its first segment boundary
STRADDLE_GENE = 33
#: the bench phase's row sizes, the harness's defaults: a 512 Mbp headline,
#: 64 Mbp hit-dense, k = 10 and strobe genomes, and 6 x 512 Mbp records
BENCH_SIZES = {"n_mbp": 512.0, "dense_mbp": 64.0, "k10_mbp": 64.0, "strobe_mbp": 64.0, "g3_mbp": 3200.0}

#: the aligner phase's large batch: windows cut around every planted gene
#: at these shifts (bp), cluster mode's per-record superset size at size
ALIGN_SHIFTS = tuple(range(-100, 100, 25))
#: integer operations of one DP cell of the function A1 computes (its
#: work, not the kernel's instructions): E (two adds, a max), the diagonal
#: (the score's lookup, an add), G (a max), F (two adds, a max), H (a max)
#: and the four decisions (compares); the traceback visits about m + n of
#: the m x n cells and adds nothing a cell
DP_OPS_PER_CELL = 15
#: the TP phase's k and threshold: the API's own estimate for the
#: reference set's profile (``estimate_optimal_threshold``, buffer 8: 11.53
#: and 7.77, seconds to compute at k = 12), rounded; most planted genes sit
#: near 4-8, the background near 19.5 at k = 10 and 15.8 at k = 12
TP_CASES = ((10, 11.5), (12, 7.75))
#: the largest k of ScanEngine's K codes (int32), probed on one card
MAX_K = 15
#: the two-axis step: tiles of 65,536 windows (245 over a 16 Mbp contig),
#: candidate buffers of 256, four profiles at ws 289 and r 21 (one a fourth
#: of the reference set), over (clusters x data) meshes of one and four
#: devices; the first threshold case lets about one window in 10,000 below
TWO_AXIS_TILE = 65_536
TWO_AXIS_CAP = 256
TWO_AXIS_WS, TWO_AXIS_R = 289, 21
TWO_AXIS_MESHES = ((1, 1), (1, 4), (2, 2), (4, 1))

#: one H100 SXM's published peaks (NVIDIA's data sheet): device memory
#: bytes per second,
#: and the non-tensor 32-bit rate, the FP32 one (the data sheet gives no
#: INT32 rate), taken as the ceiling of the kernels' 32-bit integer
#: compares and adds; an SM has half as many INT32 lanes as FP32 lanes and
#: the FP32 rate counts a fused multiply-add as two, so the INT32 lanes
#: alone do a quarter of it
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

    def record_streams(self, codes, thrs, codes_dev=None, seg_tracker=None):
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
        from kmergma_tpu_torch.ops.align_device import align_dp
        from kmergma_tpu_torch.ops.scan_kernels import (
            codes_pair_ab_kcodes, codes_pair_multi, match_counts, pair_ab_from_kcodes, run_reduce_multi,
        )

        self.wrappers = {
            "fused_record_bitmaps": fused_record_bitmaps, "match_counts": match_counts,
            "fused_cluster_record_bitmaps": fused_cluster_record_bitmaps,
            "codes_pair_multi": codes_pair_multi, "lookup_roundtrip": lookup_roundtrip,
            "codes_pair_ab_kcodes": codes_pair_ab_kcodes, "pair_ab_from_kcodes": pair_ab_from_kcodes,
            "hash_genome": hash_genome, "align_dp": align_dp, "run_reduce_multi": run_reduce_multi,
        }

    def reset(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0
        self.wrappers["run_reduce_multi"].kernel_launches = 0

    def read(self) -> dict:
        """Each wrapper's count, and R1's kernel launches beside its calls
        (``run_reduce_multi_kernel``: one a call for up to 510 profiles)."""
        out = {name: fn.launches for name, fn in self.wrappers.items()}
        out["run_reduce_multi_kernel"] = self.wrappers["run_reduce_multi"].kernel_launches
        return out


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


class R1Capture:
    """Keeps the inputs of the largest R1 call (``run_reduce_multi``, by
    region rows) made during one captured call of an entry point, and the
    profiles of each R1 call then; the kernel itself still runs."""

    def __init__(self):
        from kmergma_tpu_torch.ops import scan_kernels

        self.module, self.real = scan_kernels, scan_kernels.run_reduce_multi
        self.args, self.profiles, self.done = None, [], False

    def _spy(self, ds, starts, nvrs, thrs, nws, mis, buckets):
        self.profiles.append(len(ds))
        if self.args is None or sum(d.shape[0] for d in ds) > sum(d.shape[0] for d in self.args[0]):
            self.args = ([d.clone() for d in ds], [x.clone() for x in starts], [x.clone() for x in nvrs],
                         list(thrs), list(nws), list(mis), list(buckets))
        return self.real(ds, starts, nvrs, thrs, nws, mis, buckets)

    def once(self, call):
        """``call``, its first run captured."""
        def wrapped():
            if self.done:
                return call()
            self.done = True
            self.module.run_reduce_multi = self._spy
            try:
                return call()
            finally:
                self.module.run_reduce_multi = self.real
        return wrapped


#: 32-bit operations R1's function does a region window: the mask's four
#: compares and three ands, the rise and fall tests (two each) and the
#: segmented scan's combine (a compare, an or, two selects and an add)
R1_OPS_PER_WINDOW = 16


def r1_io(args) -> tuple[int, int]:
    """(bytes, operations) of R1's function on one call's inputs: each
    profile's distances, starts and region count read once and its part of
    the output written once; ``R1_OPS_PER_WINDOW`` a region window."""
    from kmergma_tpu_torch.ops.scan_kernels import run_reduce_size

    ds, starts, _nvrs, _thrs, _nws, _mis, buckets = args
    n_win = sum(d.numel() for d in ds)
    n_bytes = 4 * n_win + sum(8 * x.numel() + 4 for x in starts) + 4 * sum(run_reduce_size(R) for R in buckets)
    return n_bytes, R1_OPS_PER_WINDOW * n_win


def r1_measure(args, on_card: bool, what: str, label: str) -> dict:
    """R1 against its plain twin (the torch chain it replaced) on one
    captured call's inputs: wrapper ms by CUDA events back to back
    (``kernel_ms``), R1's device ms queued behind a spin, both sides'
    device ms summed by torch.profiler (the twin's tens of launches a
    profile cannot be queued ahead of the card), the bound, the error."""
    from kmergma_tpu_torch.ops.scan_kernels import _run_reduce_multi_plain, run_reduce_multi, run_reduce_size

    ms, got = kernel_ms(lambda: run_reduce_multi(*args), on_card)
    plain_ms, want = kernel_ms(lambda: _run_reduce_multi_plain(*args), on_card, reps=5)
    err = max_err((got, want))
    io = r1_io(args)
    host = got.cpu().numpy()
    offs = [0]
    for R in args[6]:
        offs.append(offs[-1] + run_reduce_size(R))
    row = {"profiles": len(args[0]), "rows": [d.shape[0] for d in args[0]], "rspan": args[0][0].shape[1],
           "run_buckets": list(args[6]), "n_runs": [int(host[o + 2]) for o in offs[:-1]],
           "ms": float(ms), "ms_min": ms.min, "plain_ms": float(plain_ms), "plain_ms_min": plain_ms.min,
           "bound_ms": bound(*io)[0], "bound_by": bound(*io)[1], "max_abs_err": err,
           "device_ms": None, "device_profiled_ms": None, "plain_device_profiled_ms": None}
    if on_card:
        row["device_ms"] = queued_device_ms(lambda: run_reduce_multi(*args), reps=r1_queued_reps(len(args[0])))
        row["device_profiled_ms"], _ = device_ms_per_call(lambda: run_reduce_multi(*args))
        # the chain's tens of launches a profile: fewer profiled calls past a few profiles
        row["plain_device_profiled_ms"], _ = device_ms_per_call(lambda: _run_reduce_multi_plain(*args),
                                                                reps=max(1, 20 // len(args[0])))
    dev = "" if not on_card else (f", device {row['device_ms']:.5f} ms (profiled {row['device_profiled_ms']:.5f}); "
                                  f"the torch chain profiled {row['plain_device_profiled_ms']:.5f} ms")
    print(f"R1 run_reduce_multi on the {what} cell's captured planned pass ({row['profiles']} profiles, "
          f"{sum(row['rows'])} region rows of {row['rspan']}, runs {row['n_runs']}): {ms:.4f} ms (fastest window "
          f"{ms.min:.4f}){dev}, the torch chain {plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
          f"bit-identical={err == 0} [{label}]")
    require(err == 0, f"R1 differs from its plain twin on the {what} cell's inputs")
    return {**row, "io": io, "ms_obj": ms, "plain_ms_obj": plain_ms}


def r1_queued_reps(m: int) -> int:
    """R1 calls of m profiles to queue behind ``queued_device_ms``' spin:
    the wrapper's host time grows with m (about 6 us a profile), and the
    queued calls must be issued before the spin ends, or host time enters
    the interval; 20 calls at m = 1, 2 at m = 84."""
    return max(2, min(20, 120 // m))


def r1_synthetic(device, label: str) -> tuple[int, int]:
    """(max_abs_err, calls) of R1 against its twin on the edge cases of
    ``tests/_r1_cases.py`` (runs over three and more adjacent regions,
    border flags on rows that do not touch, rows past nvr, mi cuts, ties,
    n_runs over R, nvr over the region bucket, one row, 6, 32, 33 and 84
    profiles of different region counts), each one call, and all single-profile
    cases in one call, at rows of 1,024 and of 64 windows."""
    import importlib.util

    import torch

    from kmergma_tpu_torch.ops.scan_kernels import _run_reduce_multi_plain, run_reduce_multi

    spec = importlib.util.spec_from_file_location("_r1_cases", ROOT / "tests" / "_r1_cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    calls = []
    for rspan in (1024, 64):
        per_case = [cases.r1_case(name, rspan=rspan, seed=4) for name in cases.R1_CASES]
        calls += per_case + [[p for profiles in per_case if len(profiles) == 1 for p in profiles]]
    err = 0
    for profiles in calls:
        args = ([torch.from_numpy(p["d"]).to(device) for p in profiles],
                [torch.from_numpy(p["starts"]).to(device) for p in profiles],
                [torch.tensor(p["nvr"], dtype=torch.int32, device=device) for p in profiles],
                [p["thr"] for p in profiles], [p["nw"] for p in profiles], [p["mi"] for p in profiles],
                [p["R"] for p in profiles])
        err = max(err, max_err((run_reduce_multi(*args), _run_reduce_multi_plain(*args))))
    print(f"R1 on {len(calls)} synthetic calls ({', '.join(cases.R1_CASES)}; each case one call and the "
          f"single-profile ones together, rows of 1,024 and 64 windows): max_abs_err {err} against the twin [{label}]")
    require(err == 0, "R1 differs from its plain twin on a synthetic case")
    return err, len(calls)


def r1_phase(ctx) -> dict:
    """R1's row: against its twin on the inputs captured from the single,
    cluster, fragmented, strobe and many-clusters (m = 35 and 84) cells'
    real calls and on the synthetic cases; ``launches`` from the
    single-profile path, each phase's wrapper calls in ``phase_launches``
    and its kernel launches in ``kernel_launches``."""
    on_card, label = ctx["on_card"], ctx["label"]
    meas = {what: r1_measure(args, on_card, what, label) for what, args in ctx["r1_inputs"].items()}
    syn_err, n_calls = r1_synthetic(ctx["device"], label)
    err = max(syn_err, *(m["max_abs_err"] for m in meas.values()))
    single = meas["single"]
    shapes = {what: {k: v for k, v in m.items() if k not in ("io", "ms_obj", "plain_ms_obj")} for what, m in meas.items()}
    print(f"R1 calls a phase {ctx['r1_launches']}, kernel launches a phase {ctx['r1_kernel_launches']} [{label}]")
    return entry("run_reduce_multi", "run_reduce.cu", "kmergma_tpu/ops/scan.py:620", ctx["r1_launches"]["single"], err,
                 single["ms_obj"], single["plain_ms_obj"], *single["io"], device_ms=single["device_ms"], shapes=shapes,
                 phase_launches=ctx["r1_launches"], kernel_launches=ctx["r1_kernel_launches"], synthetic_calls=n_calls)


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

    device, on_card, label = ctx["device"], ctx["on_card"], ctx["label"]
    profile, thr, contigs = ctx["profile"], ctx["thr"], ctx["contigs"]
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
    k1_ms, bm = kernel_ms(lambda: fused_record_bitmaps(prep, engine.s_dev, thr=thr_int, l0=l0, nw=nw, **kw), on_card)
    k1_plain_ms, bm_plain = kernel_ms(lambda: fused_record_bitmaps_plain(prep, engine.s_dev, thr=thr_int, l0=l0, nw=nw, **kw), on_card, reps=3)
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
    cap = R1Capture()
    ctx["launches"].reset()
    out = cap.once(lambda: kt.find_genes(str(fasta), REF, verbose=False, do_return_hit_loci=True, device=device))()
    hits = out[0]
    ctx["uninterrupted"]["single"] = out
    launches = ctx["launches"].read()
    require(cap.args is not None, "find_genes made no R1 call")
    ctx["r1_inputs"]["single"], ctx["r1_launches"]["single"] = cap.args, launches["run_reduce_multi"]
    ctx["r1_kernel_launches"]["single"] = launches["run_reduce_multi_kernel"]
    print(f"find_genes {total_bp} bp ({len(contigs)} contigs): {len(hits)} hits [{label}]")
    t0 = time.perf_counter()
    oracle_res = mine_genome(str(fasta), profile, thr=thr, engine=HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r))
    print(f"int64 host oracle (HostScanEngine): {time.perf_counter() - t0:.3f} s, {len(oracle_res.hits)} hits [{label}]")
    require(len(hits) > 0, "no hits on the planted genome")
    require(
        [(h.description, h.seq) for h in hits] == [(h.description, h.seq) for h in oracle_res.hits],
        "find_genes hits differ from the int64 host oracle",
    )
    print(f"hits equal the host oracle's; launch counts of the call: {launches}")
    if on_card:
        require(launches["fused_record_bitmaps"] > 0 and launches["match_counts"] > 0
                and launches["run_reduce_multi"] > 0, f"a kernel of the single-profile path never launched: {launches}")
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
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma_tpu_torch.ops.scan_cluster_fused import (
        _k3_args, _lookup_roundtrip_plain, cluster_launch_shape, cluster_tables_in_smem, lookup_roundtrip,
    )
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_thresholds

    device, on_card, label = ctx["device"], ctx["on_card"], ctx["label"]
    contigs, clusters, cthrs = ctx["contigs"], ctx["clusters"], ctx["cthrs"]
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
    k3 = k3_measure(ceng, record, cthrs, on_card)
    k3_ms, k3_plain_ms, k3_err, k3_io, bm3 = k3["ms"], k3["plain_ms"], k3["err"], k3["io"], k3["bm"]
    cprep, cthr_ints, l0s, nws, kw3 = k3["prep"], k3["thr_ints"], k3["l0s"], k3["nws"], k3["kw"]
    n_tiles = kw3["n_tiles"]
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
    del cprep, bm3, k3, back, back_plain

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
    cap = R1Capture()
    ctx["launches"].reset()
    out = cap.once(lambda: kt.find_genes_cluster_mode(str(fasta), REF, verbose=False, do_return_hit_loci=True,
                                                      device=device))()
    chits = out[0]
    ctx["uninterrupted"]["cluster"] = out
    claunches = ctx["launches"].read()
    # one R1 call a planned pass carries every cluster: the first pass of each record holds all m
    require(cap.args is not None and cap.profiles.count(m) >= len(ccontigs),
            f"the cluster call's R1 calls held {cap.profiles} profiles, not all {m} clusters once a record")
    ctx["r1_inputs"]["cluster"], ctx["r1_launches"]["cluster"] = cap.args, claunches["run_reduce_multi"]
    ctx["r1_kernel_launches"]["cluster"] = claunches["run_reduce_multi_kernel"]
    print(f"cluster mode: R1 calls of one find_genes_cluster_mode call held {cap.profiles} profiles ({len(ccontigs)} "
          f"records, {m} clusters) [{label}]")
    print(f"find_genes_cluster_mode {ctotal} bp ({len(ccontigs)} contigs, the last {SHORT_CONTIG_BP} bp): "
          f"{len(chits)} hits [{label}]")
    t0 = time.perf_counter()
    coracle = mine_genome_clusters(str(fasta), profiles, thr_vec=cthrs, buff=100, engine=HostClusterOracle(profiles, k))
    print(f"int64 host cluster oracle ({m} x HostScanEngine): {time.perf_counter() - t0:.3f} s, "
          f"{len(coracle.hits)} hits [{label}]")
    require(len(chits) > 0, "no cluster hits on the planted genome")
    require(
        [(h.description, h.seq) for h in chits] == [(h.description, h.seq) for h in coracle.hits],
        "find_genes_cluster_mode hits differ from the int64 host cluster oracle",
    )
    print(f"cluster hits equal the host oracle's; launch counts of the call: {claunches}")
    if on_card:
        missing = [n for n in ("fused_cluster_record_bitmaps", "codes_pair_multi", "lookup_roundtrip", "match_counts",
                               "run_reduce_multi") if claunches[n] == 0]
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


#: the many-clusters phase's sets: m clusters of the Alp_V references at
#: k = 6, cut at the midpoints between their sorted distinct distances to
#: the mean profile: every second one, the first 33, gives 35 (the set on
#: which the port refused cluster mode before); every one of them, 84
MANY_CLUSTERS = (35, 84)


def many_cluster_sets(m: int):
    """(cutoffs, clusters) of ``MANY_CLUSTERS``' m."""
    import numpy as np

    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params

    d = np.unique(np.asarray(cluster_ref_api(REF, 6, get_dists=True).dists))
    mids = [float(x) for x in (d[1:] + d[:-1]) / 2]
    cut = mids if m == len(mids) + 2 else mids[::2][: m - 2]
    clusters = eliminate_null_params(cluster_ref_api(REF, 6, cutoffs=cut))
    require(len(clusters.profiles) == m, f"the cutoffs gave {len(clusters.profiles)} clusters, not {m}")
    return cut, clusters


def many_clusters_phase(ctx) -> None:
    """Cluster mode past 32 clusters, which the port refused before:
    ``find_genes_cluster_mode`` on Loci.fasta with 35 clusters, its hits
    and loci equal to the port's CPU path; then 84 clusters through
    ``ClusterScanEngine`` over the first contig (K3, six launches: two for
    each group of 32 clusters) and the short contig (the split pass), the
    streams equal to the int64 host cluster oracle's.  R1's inputs at
    m = 35 and 84 are kept for its row; its calls and kernel launches a
    planned pass are printed."""
    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_thresholds

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    m35, m84 = MANY_CLUSTERS
    cut, clusters = many_cluster_sets(m35)
    loci = str(DATA / "Loci.fasta")
    kw = dict(cluster_cutoffs=cut, verbose=False, do_return_hit_loci=True)
    cap = R1Capture()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ctx["launches"].reset()
        wall_ms, (hits, hit_loci) = clock(cap.once(lambda: kt.find_genes_cluster_mode(loci, REF, device=device, **kw)), sync)
        launches = ctx["launches"].read()
        # on the CPU (the rehearsal) the run above is the CPU path
        want = kt.find_genes_cluster_mode(loci, REF, device="cpu", **kw) if on_card else (hits, hit_loci)
    got = ([(h.description, h.seq) for h in hits], hit_loci)
    require(got == ([(h.description, h.seq) for h in want[0]], want[1]),
            f"find_genes_cluster_mode with {m35} clusters differs from the port's CPU path")
    require(len(hits) > 0, f"no hits with {m35} clusters on Loci.fasta")
    require(cap.args is not None and max(cap.profiles) == m35, f"the {m35}-cluster call's R1 calls held {cap.profiles} profiles")
    ctx["r1_inputs"][f"m{m35}"] = cap.args
    print(f"find_genes_cluster_mode, {m35} clusters (windowsizes {sorted(set(clusters.windowsizes))}), Loci.fasta: "
          f"{wall_ms:.1f} ms, {len(hits)} hits, loci {hit_loci}, equal to the CPU path's; R1 calls {cap.profiles} "
          f"profiles each, {launches['run_reduce_multi']} calls and {launches['run_reduce_multi_kernel']} kernel "
          f"launches; launch counts {launches} [{label}]")
    if on_card:
        require(launches["codes_pair_multi"] > 0 and launches["match_counts"] > 0 and launches["run_reduce_multi"] > 0,
                f"the {m35}-cluster call did not run K5, K2 and R1: {launches}")
        require(launches["run_reduce_multi_kernel"] == launches["run_reduce_multi"],
                f"R1 took more than one kernel launch a call at {m35} profiles: {launches}")

    _cut, clusters = many_cluster_sets(m84)
    thrs = estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0)
    oracle = HostClusterOracle(clusters.profiles, 6)
    total = {}
    for codes, route in ((ctx["contigs"][0], "K3"), (ctx["short_contig"], "split")):
        eng = ClusterScanEngine(clusters.profiles, k=6, device=device)
        eng.fused_min_windows = 1 if route == "K3" else 1 << 30
        cap = R1Capture()
        ctx["launches"].reset()
        wall_ms, streams = clock(cap.once(lambda: eng.record_streams(codes, thrs)), sync)
        launches = ctx["launches"].read()
        total = {name: total.get(name, 0) + n for name, n in launches.items()}
        t0 = time.perf_counter()
        require(streams == oracle.minimal_streams(codes, thrs, eng.max_ws),
                f"the {m84}-cluster streams of a {codes.shape[0]} bp record ({route}) differ from the int64 host oracle")
        require(any(s for _d0, s in streams), f"no {m84}-cluster stream entries on a {codes.shape[0]} bp record")
        print(f"ClusterScanEngine, {m84} clusters, {codes.shape[0]} bp record on the {route} route: {wall_ms:.1f} ms, "
              f"{sum(len(s) for _d0, s in streams)} stream entries, equal to the int64 host cluster oracle's "
              f"({time.perf_counter() - t0:.1f} s); K3 launches {launches['fused_cluster_record_bitmaps']} "
              f"(2 x ceil({m84} / 32) = {2 * -(-m84 // 32)} on K3), K8 {launches['lookup_roundtrip']}, K5 "
              f"{launches['codes_pair_multi']}; R1 {launches['run_reduce_multi']} calls of {cap.profiles} profiles, "
              f"{launches['run_reduce_multi_kernel']} kernel launches for the planned pass(es) [{label}]")
        if route == "K3":
            ctx["r1_inputs"][f"m{m84}"] = cap.args
        if on_card:
            want_k3 = 2 * -(-m84 // 32) if route == "K3" else 0
            require(launches["fused_cluster_record_bitmaps"] == want_k3
                    and launches["lookup_roundtrip"] == -(-m84 // 32) * (route == "K3"),
                    f"the {m84}-cluster {route} pass did not launch K3 twice and K8 once a group of 32: {launches}")
            require(launches["run_reduce_multi"] > 0 and launches["run_reduce_multi_kernel"] == launches["run_reduce_multi"],
                    f"R1 did not take one kernel launch a call at {m84} profiles: {launches}")
    ctx["r1_launches"]["many_clusters"] = total["run_reduce_multi"]
    ctx["r1_kernel_launches"]["many_clusters"] = total["run_reduce_multi_kernel"]


def strobe_phase(ctx) -> list:
    """K4r against its twin on one contig's strobe codes, the strobe goldens,
    and ``strobemer_find_genes`` on the genome against the int64 host
    oracle of the strobe recurrence."""
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma_tpu_torch.ops.scan_kernels import _codes_pair_ab_kcodes_plain, codes_pair_ab_kcodes
    from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes_torch

    device, on_card, label = ctx["device"], ctx["on_card"], ctx["label"]
    contigs = ctx["contigs"]
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
    cap = R1Capture()
    ctx["launches"].reset()
    out = cap.once(lambda: kt.strobemer_find_genes(str(fasta), REF, verbose=False, do_return_hit_loci=True,
                                                   device=device))()
    shits = out[0]
    ctx["uninterrupted"]["strobe"] = out
    slaunches = ctx["launches"].read()
    require(cap.args is not None, "strobemer_find_genes made no R1 call")
    ctx["r1_inputs"]["strobe"], ctx["r1_launches"]["strobe"] = cap.args, slaunches["run_reduce_multi"]
    ctx["r1_kernel_launches"]["strobe"] = slaunches["run_reduce_multi_kernel"]
    print(f"strobemer_find_genes {total_bp} bp ({len(contigs)} contigs): {len(shits)} hits [{label}]")
    t0 = time.perf_counter()
    soracle = strobe_mine_genome(str(fasta), profile, thr=thr, device_extract=False, device=device,
                                 engine_factory=HostStrobeOracle)
    print(f"int64 host strobe oracle (sorted-key window counts, all {len(contigs)} contigs): "
          f"{time.perf_counter() - t0:.3f} s, {len(soracle.hits)} hits [{label}]")
    require(len(shits) > 0, "no strobe hits on the planted genome")
    require(
        [(h.description, h.seq) for h in shits] == [(h.description, h.seq) for h in soracle.hits],
        "strobemer_find_genes hits differ from the int64 host strobe oracle",
    )
    print(f"strobe hits equal the host oracle's; launch counts of the call: {slaunches}")
    if on_card:
        require(slaunches["codes_pair_ab_kcodes"] > 0 and slaunches["match_counts"] > 0
                and slaunches["run_reduce_multi"] > 0, f"a kernel of the strobe path never launched: {slaunches}")
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
    total = dict.fromkeys(ctx["launches"].read(), 0)
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
                    and launches["match_counts"] > 0 and launches["run_reduce_multi"] > 0,
                    f"the mixed-depth pass did not run K4, K6, K2 and R1: {launches}")
    ctx["r1_launches"]["mixed_depth"] = total["run_reduce_multi"]
    ctx["r1_kernel_launches"]["mixed_depth"] = total["run_reduce_multi_kernel"]
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


#: the engine-options phase's cluster depths: two that K3 and K5 take (one
#: past the default 16), one past MAX_BITMAP_DEPTH (K4 and K6) and exact
#: mode (None: each group's ws - k, K4 and K6)
OPTION_DEPTHS = (8, 64, 270, None)
#: the depth-route shapes the phase times: K4 and K6 at 270 and at the
#: single profile's full depth ws - k = 283, K3 at 8 and 64, K5 at 64
OPTION_K46_DEPTHS = (270, 283)
OPTION_K3_DEPTHS = (8, 64)
OPTION_K5_DEPTH = 64


def option_kernel_shapes(ctx, engines: dict) -> dict:
    """K4, K6, K3 and K5 against their twins at the shapes the engines'
    options give them on the first contig (K5 on the short contig): K4 at
    ``OPTION_K46_DEPTHS`` on the single-profile depth route, K6 there at
    the exact cluster split pass's span and the single profile's width, K3 at
    ``OPTION_K3_DEPTHS`` (m = 6) and K5 at ``OPTION_K5_DEPTH``.  Returns
    {kernel row name: {shape name: {depth, ms, ms_min, plain_ms,
    max_abs_err, device_ms, bound_ms, bound_by}}}."""
    from kmergma_tpu_torch.ops.scan import _pair_ab
    from kmergma_tpu_torch.ops.scan_kernels import (
        _codes_pair_ab_kcodes_plain, _pair_depth_need, codes_pair_ab_kcodes, pair_ab_from_kcodes,
    )

    on_card, label, profile = ctx["on_card"], ctx["label"], ctx["profile"]
    record, cthrs = ctx["contigs"][0], ctx["cthrs"]
    k, ws = profile.k, profile.windowsize
    out: dict = {"codes_pair_ab_kcodes[K4]": {}, "pair_ab_from_kcodes": {}, "fused_cluster_record_bitmaps": {},
                 "codes_pair_multi": {}}

    def row(v, depth) -> dict:
        b = bound(*v["io"])
        return {"depth": depth, "ms": float(v["ms"]), "ms_min": v["ms"].min, "plain_ms": float(v["plain_ms"]),
                "max_abs_err": v["err"], "device_ms": v.get("device_ms"), "bound_ms": b[0], "bound_by": b[1]}

    def show(name, depth, what, v) -> None:
        dev = "" if v.get("device_ms") is None else f", device {v['device_ms']:.5f} ms"
        print(f"{name} at depth {depth}, {what}: {v['ms']:.4f} ms (fastest window {v['ms'].min:.4f}){dev}, plain twin "
              f"{v['plain_ms']:.3f} ms, bound {bound(*v['io'])[0]:.4f} ms ({bound(*v['io'])[1]}), "
              f"bit-identical={v['err'] == 0} [{label}]")
        require(v["err"] == 0, f"{name} at depth {depth} differs from its plain twin")

    # K4 on the single-profile depth route: w = ws - k + 1, every window
    w = ws - k + 1
    prep = engines["single_exact"].prepare_codes(record)
    nw = record.shape[0] - ws + 1
    nt, nkc = nw - 1, nw + w - 1
    for depth in OPTION_K46_DEPTHS:
        args = (prep, k, w, nt, nkc, depth)
        ms, (ab, kc) = kernel_ms(lambda: codes_pair_ab_kcodes(*args), on_card)
        pms, (ab_p, kc_p) = kernel_ms(lambda: _codes_pair_ab_kcodes_plain(*args), on_card, reps=1)
        v = {"ms": ms, "plain_ms": pms, "err": max_err((ab, ab_p), (kc, kc_p)),
             "io": (_pair_depth_need(k, w, nt, nkc)[1] + 4 * (nt + nkc), 4 * depth * nt),
             "device_ms": queued_device_ms(lambda: codes_pair_ab_kcodes(*args)) if on_card else None}
        show("K4", depth, f"single-profile depth route, {nt} transitions of a {record.shape[0]} bp record", v)
        out["codes_pair_ab_kcodes[K4]"][f"single_d{depth}"] = row(v, depth)
    # K6 at the exact cluster split pass's span, at the single profile's width
    ceng = engines["cluster_exact"]
    cprep = ceng.prepare_codes(record)
    nt = ceng._split_span(record.shape[0] - min(e.ws for e in ceng.engines) + 1) - 1
    kc_g = codes_pair_ab_kcodes(cprep, k, w, nt, nt + w, OPTION_K46_DEPTHS[0])[1]
    for depth in OPTION_K46_DEPTHS:
        ms, ab6 = kernel_ms(lambda: pair_ab_from_kcodes(kc_g, w, nt, depth), on_card)
        pms, ab6_p = kernel_ms(lambda: _pair_ab(kc_g, w, nt, depth), on_card, reps=1)
        v = {"ms": ms, "plain_ms": pms, "err": max_err((ab6, ab6_p)), "io": (4 * (nt + w) + 4 * nt, 4 * depth * nt),
             "device_ms": queued_device_ms(lambda: pair_ab_from_kcodes(kc_g, w, nt, depth)) if on_card else None}
        show("K6", depth, f"cluster split pass's span, ws {ws}, {nt} transitions", v)
        out["pair_ab_from_kcodes"][f"cluster_d{depth}"] = row(v, depth)
    del prep, cprep, kc_g
    # K3 at m = 6 and K5 on the short contig, at the cluster engines' depths
    for depth in OPTION_K3_DEPTHS:
        v = k3_measure(engines[f"cluster_d{depth}"], record, cthrs, on_card)
        show("K3", depth, f"{len(cthrs)} clusters, {record.shape[0]} bp record", v)
        out["fused_cluster_record_bitmaps"][f"d{depth}"] = row(v, depth)
    k5 = k5_measure(engines[f"cluster_d{OPTION_K5_DEPTH}"], ctx["short_contig"], (SHORT_CONTIG_BP,), on_card, label)
    v = k5[SHORT_CONTIG_BP]
    out["codes_pair_multi"][f"d{OPTION_K5_DEPTH}_{SHORT_CONTIG_BP}"] = row(v, OPTION_K5_DEPTH)
    return out


def engine_options_phase(ctx) -> dict:
    """The scan engines' depth options at full width, on the first contig
    and the short contig against the six clusters and the single profile
    (ws 289, k 6): ``ClusterScanEngine`` at each of ``OPTION_DEPTHS`` (K3 or
    K5 at 8 and 64, K4 and K6 at 270 and in exact mode), ``ScanEngine`` at
    270 and in exact mode (K4), ``ShardedScanEngine`` at both over 1 and 4
    logical shards of the first device (K4 on each shard),
    ``ShardedClusterScanEngine`` in exact mode over 4, and the strobe span
    engine bounded at depth 16 (K4 over byte codes).  Every stream equals
    the default-depth engine's on the same record (a deeper or exact bitmap
    only narrows the regions), and those equal the int64 host oracles';
    each call's wall is printed beside the default engine's, and its route
    is held by its launch counts.  Then the kernels at those shapes
    (``option_kernel_shapes``).  Returns {"launches": every kernel's
    launches over the phase's counted calls, "shapes": the kernel rows'
    new shapes}.

    First, after the default engines, ``ScanEngine(S, k, ws, r, chunk)``
    and ``ClusterScanEngine(profiles, k, chunk)`` as a JAX caller writes
    them, ``chunk_windows`` by position and the card by default: with a
    chunk that cuts the first contig into two segments, ``ScanEngine``
    takes the segmented route (K1 twice a segment); the cluster engine,
    which does not segment, launches as the default one."""
    import numpy as np
    import torch

    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.scan_host import HostScanEngine
    from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes_torch
    from kmergma_tpu_torch.parallel.mesh import make_mesh
    from kmergma_tpu_torch.parallel.sharded_scan import ShardedClusterScanEngine, ShardedScanEngine

    device, on_card, sync, label, launches = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"], ctx["launches"]
    profile, thr, clusters, cthrs = ctx["profile"], ctx["thr"], ctx["clusters"], list(map(float, ctx["cthrs"]))
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    records = [ctx["contigs"][0], ctx["short_contig"]]
    total = dict.fromkeys(launches.read(), 0)

    def call(fn):
        """(launch counts, wall ms, result) of one call of ``fn``, after one
        warm-up call on the card; the counts are added to the phase's."""
        if on_card:
            fn()
        launches.reset()
        ms, out = clock(fn, sync)
        got = launches.read()
        for name, n in got.items():
            total[name] += n
        return got, ms, out

    def route(got) -> str:
        names = (("K1", "fused_record_bitmaps"), ("K3", "fused_cluster_record_bitmaps"), ("K5", "codes_pair_multi"),
                 ("K4", "codes_pair_ab_kcodes"), ("K6", "pair_ab_from_kcodes"), ("K2", "match_counts"),
                 ("R1", "run_reduce_multi"))
        return ", ".join(f"{short} {got[name]}" for short, name in names)

    # --- the default-depth engines' streams, held against the int64 oracles ---
    host = HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r)
    coracle = HostClusterOracle(clusters.profiles, k)
    cone = ClusterScanEngine(clusters.profiles, k=k, device=device)
    one = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    base = []
    for codes in records:
        n = codes.shape[0]
        cgot, cms, cwant = call(lambda: cone.record_streams(codes, cthrs))
        _got, sms, swant = call(lambda: one.record_stream(codes, thr)[:2])
        d = host._dists(codes)
        require(cwant == coracle.minimal_streams(codes, cthrs, cone.max_ws),
                f"the default cluster engine's streams differ from the int64 host oracle's on a {n} bp record")
        require(swant == (float(d[0]) / host.scale, minimal_stream(d, host.scale, thr, n - ws)),
                f"the default ScanEngine's stream differs from the int64 host oracle's on a {n} bp record")
        require(len(swant[1]) > 0 and any(s for _d0, s in cwant), f"no stream entries on the {n} bp record")
        base.append({"cluster": (cms, cwant), "single": (sms, swant), "cluster_launches": cgot})
        print(f"engine options, {n} bp record: the default-depth (16) engines' streams equal the int64 host oracles' "
              f"(ClusterScanEngine {cms:.3f} ms, {[len(s) for _d0, s in cwant]} entries; ScanEngine {sms:.3f} ms, "
              f"{len(swant[1])} entries) [{label}]")

    def check(what, i, got, ms, out, kind, want_route: dict) -> None:
        n = records[i].shape[0]
        base_ms, want = base[i][kind]
        require(out == want, f"{what} on the {n} bp record: streams differ from the default-depth engine's")
        print(f"{what}, {n} bp record: {ms:.3f} ms (default depth 16: {base_ms:.3f} ms), streams equal the default "
              f"engine's and the int64 host oracle's; launches {route(got)} [{label}]")
        if on_card:
            wrong = {name: got[name] for name, n_l in want_route.items() if got[name] != n_l}
            require(not wrong and got["match_counts"] > 0 and got["run_reduce_multi"] > 0,
                    f"{what} on the {n} bp record did not take its route: {route(got)}")

    # --- the engines built as a JAX caller writes them: chunk_windows by position --
    # a chunk that cuts the first record into two segments of 2 x chunk windows
    nw0 = records[0].shape[0] - ws + 1
    chunk = 1 << max(10, (nw0 // 3).bit_length() - 1)
    on_dev = {} if on_card else {"device": device}  # the card by default
    positional = {"ScanEngine": ScanEngine(profile.sum_kfv, k, ws, r, chunk, **on_dev),
                  "ClusterScanEngine": ClusterScanEngine(clusters.profiles, k, chunk, **on_dev)}
    for name, eng in positional.items():
        require(eng.chunk == chunk and eng.device == one.device and eng.device.index in (None, 0),
                f"{name} built with chunk_windows {chunk} by position has chunk {eng.chunk} on {eng.device}")
    for i, codes in enumerate(records):
        n = codes.shape[0]
        nw = n - ws + 1
        n_seg = -(-nw // (2 * chunk))
        require(isinstance(codes, np.ndarray) and (i > 0 or n_seg == 2), f"the {n} bp record takes no segmented route")
        got, ms, out = call(lambda: positional["ScanEngine"].record_stream(codes, thr)[:2])
        base_ms, want = base[i]["single"]
        require(out == want, f"ScanEngine with chunk_windows {chunk} by position differs on the {n} bp record")
        print(f"ScanEngine(S, k, ws, r, {chunk}) as a JAX caller writes it, {n} bp record: on {one.device}, "
              f"{'one pass' if n_seg == 1 else f'{n_seg} segments of {2 * chunk} windows'}, {ms:.3f} ms (default engine: "
              f"{base_ms:.3f} ms), the same stream as the default engine and the int64 host oracle; launches "
              f"{route(got)} [{label}]")
        if on_card:
            off = ("fused_cluster_record_bitmaps", "codes_pair_multi", "codes_pair_ab_kcodes", "pair_ab_from_kcodes")
            require(got["fused_record_bitmaps"] == 2 * n_seg and got["match_counts"] > 0 and got["run_reduce_multi"] > 0
                    and not any(got[name] for name in off),
                    f"ScanEngine with chunk_windows {chunk} on the {n} bp record: predicted K1 {2 * n_seg}, K2 and R1, "
                    f"no other kernel; launched {route(got)}")
        got, ms, out = call(lambda: positional["ClusterScanEngine"].record_streams(codes, cthrs))
        base_ms, want = base[i]["cluster"]
        require(out == want, f"ClusterScanEngine with chunk_windows {chunk} by position differs on the {n} bp record")
        print(f"ClusterScanEngine(profiles, {k}, {chunk}) as a JAX caller writes it, {n} bp record: {ms:.3f} ms "
              f"(default engine: {base_ms:.3f} ms), the same streams as the default engine and the int64 host oracle "
              f"(the cluster engine does not segment); launches {route(got)} [{label}]")
        if on_card:
            require(got == base[i]["cluster_launches"],
                    f"ClusterScanEngine with chunk_windows {chunk} on the {n} bp record launched {route(got)}, the "
                    f"default engine {route(base[i]['cluster_launches'])}")

    # --- ClusterScanEngine at each depth ----------------------------------------
    engines = {}
    none = {"fused_cluster_record_bitmaps": 0, "codes_pair_multi": 0, "codes_pair_ab_kcodes": 0,
            "pair_ab_from_kcodes": 0, "fused_record_bitmaps": 0}
    for depth in OPTION_DEPTHS:
        eng = ClusterScanEngine(clusters.profiles, k=k, device=device, bound_depth=depth)
        engines["cluster_exact" if depth is None else f"cluster_d{depth}"] = eng
        name = "exact" if depth is None else depth
        for i, codes in enumerate(records):
            got, ms, out = call(lambda: eng.record_streams(codes, cthrs))
            if eng.shared_depth is None:
                want_route = {**none, "codes_pair_ab_kcodes": 1, "pair_ab_from_kcodes": len(eng.groups) - 1}
            elif max(codes.shape[0] - e.ws + 1 for e in eng.engines) >= eng.fused_min_windows:
                want_route = {**none, "fused_cluster_record_bitmaps": 2 * len(eng.k3_groups)}  # two a call
            else:
                want_route = {**none, "codes_pair_multi": 1}
            check(f"ClusterScanEngine bound_depth {name} (groups {[(g[0], g[1]) for g in eng.groups]})", i, got, ms,
                  out, "cluster", want_route)

    # --- ScanEngine and ShardedScanEngine on the depth route --------------------
    first = device if device.type == "cpu" else torch.device("cuda", 0)
    meshes = {n_dev: make_mesh(devices=[first] * n_dev) for n_dev in (1, 4)}
    for depth in (270, None):
        name = "exact" if depth is None else depth
        eng = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device, bound_depth=depth)
        if depth is None:
            engines["single_exact"] = eng
        for i, codes in enumerate(records):
            got, ms, out = call(lambda: eng.record_stream(codes, thr)[:2])
            check(f"ScanEngine bound_depth {name}", i, got, ms, out, "single", {**none, "codes_pair_ab_kcodes": 1})
        for n_dev, mesh in meshes.items():
            sh = ShardedScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=mesh, bound_depth=depth)
            for i, codes in enumerate(records):
                got, ms, out = call(lambda: sh.record_stream(codes, thr)[:2])
                check(f"ShardedScanEngine bound_depth {name} over {n_dev} logical shards of {first}", i, got, ms, out,
                      "single", {**none, "codes_pair_ab_kcodes": n_dev})
    csh = ShardedClusterScanEngine(clusters.profiles, k=k, mesh=meshes[4], bound_depth=None)
    for i, codes in enumerate(records):
        got, ms, out = call(lambda: csh.record_streams(codes, cthrs))
        check(f"ShardedClusterScanEngine bound_depth exact over 4 logical shards of {first}", i, got, ms, out, "cluster",
              {**none, "codes_pair_ab_kcodes": 4, "pair_ab_from_kcodes": 4 * (len(csh.groups) - 1)})

    # --- the strobe span engine bounded at depth 16 ------------------------------
    sprof = gen_strobe_ref_ws_cons(REF)
    sthr, sw = 30.0, sprof.windowsize - sprof.k
    sscale = 2.0 * sprof.k * sprof.n_records**2
    for codes in records:
        n = codes.shape[0]
        n_steps = n - sprof.windowsize - 1
        sc = strobe_2_mer_codes_torch(torch.from_numpy(codes).to(device), sprof.s, sprof.w_min, sprof.w_max, sprof.q)
        sc = sc[: n_steps + sw]
        xstar = int(sc[sw])
        exact = StrobeSpanEngine(sprof, xstar, device=device)
        bounded = StrobeSpanEngine(sprof, xstar, bound_depth=16, device=device)
        _got, ems, ewant = call(lambda: exact.record_stream(sc, sthr)[:2])
        got, ms, out = call(lambda: bounded.record_stream(sc, sthr)[:2])
        d = strobe_distances_i64(sc.cpu().numpy(), sprof.sum_kfv, sw, sprof.n_records)
        require(ewant == (float(d[0]) / sscale, minimal_stream(d, sscale, sthr, n_steps)),
                f"the exact strobe span engine's stream differs from the int64 host oracle's on the {n} bp record")
        require(out == ewant, f"the strobe span engine at depth 16 differs from the exact engine on the {n} bp record")
        print(f"StrobeSpanEngine bound_depth 16, {n} bp record: {ms:.3f} ms (exact mode, the default: {ems:.3f} ms), "
              f"stream equal to the exact engine's and the int64 host oracle's, {len(out[1])} entries; launches "
              f"{route(got)} [{label}]")
        if on_card:
            require(got["codes_pair_ab_kcodes"] == 1 and got["fused_record_bitmaps"] == 0 and got["match_counts"] > 0,
                    f"the bounded strobe engine did not take K4: {route(got)}")

    shapes = option_kernel_shapes(ctx, engines)
    return {"launches": total, "shapes": shapes}


def engine_options_cards(contig, devices: list, label: str) -> None:
    """``ShardedScanEngine`` in exact mode and at depth 270 over the cards
    in ``devices`` (``--mesh-cards``: four), each shard's bitmap from K4 on
    its own card: the stream equals the one-device default engine's, with
    one K4 launch a card; each wall beside the one-device engine's."""
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_threshold
    from kmergma_tpu_torch.parallel.mesh import make_mesh
    from kmergma_tpu_torch.parallel.sharded_scan import ShardedScanEngine

    import torch

    sync = torch.cuda.synchronize if devices[0].type == "cuda" else (lambda: None)
    profile = gen_ref_ws_cons(REF, 6)
    thr = estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0)
    kw = dict(k=profile.k, ws=profile.windowsize, r=profile.n_records)
    one = ScanEngine(profile.sum_kfv, device=devices[0], **kw)
    one.record_stream(contig, thr)
    one_ms, want = clock(lambda: one.record_stream(contig, thr)[:2], sync)
    launches = Launches()
    for depth in (None, 270):
        sh = ShardedScanEngine(profile.sum_kfv, mesh=make_mesh(devices=devices), bound_depth=depth, **kw)
        sh.record_stream(contig, thr)
        launches.reset()
        ms, got = clock(lambda: sh.record_stream(contig, thr)[:2], sync)
        n = launches.read()
        require(got == want, f"ShardedScanEngine bound_depth {depth} over {len(devices)} devices differs from ScanEngine")
        on_k4 = n["codes_pair_ab_kcodes"] == len(devices) and n["fused_record_bitmaps"] == 0
        require(devices[0].type != "cuda" or on_k4,
                f"ShardedScanEngine bound_depth {depth} over {len(devices)} devices: K4 {n['codes_pair_ab_kcodes']}, "
                f"K1 {n['fused_record_bitmaps']}")
        print(f"ShardedScanEngine bound_depth {'exact' if depth is None else depth} over {len(devices)} devices "
              f"{[str(d) for d in devices]}, {contig.shape[0]} bp record: {ms:.3f} ms (one-device default engine "
              f"{one_ms:.3f} ms), stream equal, K4 {n['codes_pair_ab_kcodes']} launches [{label}]")


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
    ctx["r1_launches"]["fragmented"] = launches["run_reduce_multi"]
    ctx["r1_kernel_launches"]["fragmented"] = launches["run_reduce_multi_kernel"]
    if on_card:
        require(launches["codes_pair_multi"] == n_rec and launches["fused_cluster_record_bitmaps"] == 0,
                f"the fragmented records did not take K5 once each: {launches}")
        require(launches["run_reduce_multi"] == n_rec,
                f"the fragmented records did not take one R1 call each, all {len(profiles)} clusters in it: {launches}")
    oracle = HostClusterOracle(profiles, k)
    for i in range(n_oracle):
        require(streams[i] == oracle.minimal_streams(recs[i], cthrs, eng.max_ws),
                f"fragment {i}'s cluster streams differ from the int64 host oracle")
    require(any(s for st in streams for _d, s in st), "no cluster stream entries on the fragmented genome")
    # R1's inputs from the planned pass of the first record with stream entries
    cap = R1Capture()
    hit = next(i for i, st in enumerate(streams) if any(s for _d, s in st))
    cap.once(lambda: eng.record_streams(recs[hit], cthrs))()
    ctx["r1_inputs"]["fragmented"] = cap.args
    print(f"the first {n_oracle} fragments' streams equal the int64 host cluster oracle's [{label}]")
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
    args = (prep, engine.s_dev)
    kw = dict(thr=int(engine._thr_int(thr)), l0=l0, nw=nw, k=engine.k, ws=engine.ws, r=engine.r, depth=depth,
              t=engine.fused_t, block=engine.block, n_tiles=-(-nw // engine.fused_t))
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
    tracer: the sum of the device intervals over ``reps``."""
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


def k3_measure(ceng, record, thrs, on_card: bool) -> dict:
    """K3 against its plain twin on one whole record at the cluster
    engine's shapes and depth (``shared_depth``): {ms, plain_ms, err, io,
    bm, and the call's prep, thr_ints, l0s, nws and kw}, wrapper ms from
    ``kernel_ms``."""
    import torch

    from kmergma_tpu_torch.ops.scan import _first_window_l0, _k1_halo
    from kmergma_tpu_torch.ops.scan_cluster_fused import fused_cluster_record_bitmaps, fused_cluster_record_bitmaps_plain

    k, m, depth = ceng.k, len(ceng.engines), ceng.groups[0][1]
    widths = [ws_c - k + 1 for ws_c, _r in ceng.specs]
    nws = [record.shape[0] - ws_c + 1 for ws_c, _r in ceng.specs]
    prep = ceng.prepare_codes(record)
    thr_ints = [int(e._thr_int(x)) for e, x in zip(ceng.engines, thrs)]
    l0s = torch.stack([_first_window_l0(prep, e.s_dev, k=k, ws=e.ws, r=e.r, depth=depth) for e in ceng.engines])
    n_tiles = -(-max(nws) // ceng.fused_t)
    kw = dict(k=k, specs=ceng.specs, depth=depth, t=ceng.fused_t, block=ceng.block, n_tiles=n_tiles)
    ms, bm = kernel_ms(lambda: fused_cluster_record_bitmaps(prep, ceng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw), on_card)
    plain_ms, bm_plain = kernel_ms(
        lambda: fused_cluster_record_bitmaps_plain(prep, ceng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw), on_card, reps=1
    )
    n_win = n_tiles * ceng.fused_t
    io = (n_win + _k1_halo(max(widths)) + 4 * m * 4**k + 4 * bm.numel(), (4 * depth + PROFILE_OPS_PER_WINDOW * m) * n_win)
    return {"ms": ms, "plain_ms": plain_ms, "err": max_err((bm, bm_plain)), "io": io, "bm": bm, "prep": prep,
            "thr_ints": thr_ints, "l0s": l0s, "nws": nws, "kw": kw}


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
    args = (prep, ceng.s_stack)
    kw = dict(thrs=[int(e._thr_int(x)) for e, x in zip(ceng.engines, thrs)], l0s=l0s, nws=nws, k=ceng.k,
              specs=ceng.specs, depth=depth, t=ceng.fused_t, block=ceng.block, n_tiles=-(-max(nws) // ceng.fused_t))
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

    device, on_card, label = ctx["device"], ctx["on_card"], ctx["label"]
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

    dgenome = torch.from_numpy(dense["codes"]).to(device)
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


def long_record(n_bp: int, seg_windows: int, ws: int, genes) -> "np.ndarray":
    """``n_bp`` codes of splitmix background (seed 2, ``hash_codes``, made in
    32 Mbp pieces) with the reference genes planted every 6 Mbp, cycling
    through them, and one gene straddling the first segment boundary
    (window ``seg_windows``): gene ``STRADDLE_GENE``, which lies well below
    the threshold (distance 5.63 alone on a hashed background)."""
    import numpy as np

    codes = np.empty(n_bp, dtype=np.int8)
    piece = 32_000_000
    for off in range(0, n_bp, piece):
        codes[off : off + piece] = hash_codes(min(piece, n_bp - off), off, seed=2)
    every = max(n_bp // 80, 6_000_000) if n_bp > 60_000_000 else max(n_bp // 8, 2 * ws)
    for j, pos in enumerate(range(every // 2, n_bp - every // 2, every)):
        gene = genes[j % len(genes)]
        codes[pos : pos + gene.shape[0]] = gene
    gene = genes[STRADDLE_GENE]
    straddle = seg_windows - gene.shape[0] // 2
    codes[straddle : straddle + gene.shape[0]] = gene
    return codes


def long_record_phase(ctx) -> dict:
    """Long records and shards.  One long record of host codes (512 Mbp at
    size) on the segmented path against the one-pass path on the same codes
    as a device tensor and against the int64 host engine over the whole
    record, each path's peak device memory, wall and K1 and K2 launches;
    ``mine_genome`` on it killed after 3 segments and resumed: only the
    remaining segments scanned, the uninterrupted hits, the file removed.
    Then the sharded engines over 1 and 4 logical shards of the first card
    on the phase's genome and short contig, equal to the one-device
    engines, ``find_genes(devices=1)`` and ``find_genes_cluster_mode
    (devices=1)`` equal to the API phases' hits, a one-rank process group
    (NCCL on the card) through ``initialize_distributed``, ``devices=2``
    where a second card is present, and the checkpoint's cost on the first
    256 fragments of the fragmented assembly.  Returns the launches of
    every kernel over the phase's runs."""
    import os
    import socket

    import numpy as np
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.models.miner import mine_genome
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.models.state_machine import replay_single
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.scan_host import HostScanEngine
    from kmergma_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from kmergma_tpu_torch.parallel.sharded_scan import ShardedClusterScanEngine, ShardedScanEngine
    from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    profile, thr, launches = ctx["profile"], ctx["thr"], ctx["launches"]
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    total = dict.fromkeys(launches.read(), 0)

    def counted(fn):
        """Run ``fn`` with the launch counts set to 0; add them to the
        phase's total and return (counts, result)."""
        launches.reset()
        out = fn()
        got = launches.read()
        for name, n in got.items():
            total[name] += n
        return got, out

    def peak_and_wall(fn):
        """(peak device bytes or None, wall s, launch counts, result)."""
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        got, (ms, out) = counted(lambda: clock(fn, sync))
        return (torch.cuda.max_memory_allocated() if on_card else None), ms / 1e3, got, out

    def mem(x):
        return f"{x} bytes" if x is not None else "not measured (CPU)"

    # --- one long record: segmented against one pass and the host engine ----
    engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device, chunk_windows=ctx["long_chunk"])
    seg = 2 * engine.chunk
    genes = [rec.codes for rec in as_records(REF)]
    codes = long_record(ctx["long_bp"], seg, ws, genes)
    n, nw = codes.shape[0], codes.shape[0] - ws + 1
    n_segs = -(-nw // seg)
    require(n_segs >= 4, f"the long record has {n_segs} segments; the kill needs at least 4")
    engine.record_stream(codes[: 2 * seg + ws], thr)  # warm-ups: three segments, then one pass
    engine.record_stream(torch.from_numpy(codes[: seg + ws]).to(device), thr)
    seg_peak, seg_s, seg_launch, seg_out = peak_and_wall(lambda: engine.record_stream(codes, thr))
    codes_dev = torch.from_numpy(codes).to(device)
    one_peak, one_s, one_launch, one_out = peak_and_wall(lambda: engine.record_stream(codes_dev, thr))
    del codes_dev
    require(seg_out[:2] == one_out[:2], "the segmented (dist0, stream) differs from the one-pass path's")
    # the route such a record took before it segmented: host codes in one pass,
    # on an engine whose segments hold the whole record
    whole = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device,
                       chunk_windows=-(-nw // (2 * engine.rspan)) * engine.rspan)
    cold_peak, cold_s, _, _ = peak_and_wall(lambda: whole.record_stream(codes, thr))
    pass_peak, pass_s, pass_launch, pass_out = peak_and_wall(lambda: whole.record_stream(codes, thr))
    _, pass2_s, _, _ = peak_and_wall(lambda: whole.record_stream(codes, thr))

    def parent_route():
        """The copy before pinned staging: zero-padded on the host, then a
        pageable copy of the padded codes (the pass pads a device tensor
        again, on the card)."""
        padded = np.zeros(whole._padded_len(n), dtype=np.int8)
        padded[:n] = codes
        return whole.record_stream(torch.from_numpy(padded).to(device)[:n], thr)

    page_peak, page_s, _, page_out = peak_and_wall(parent_route)
    _, page2_s, _, _ = peak_and_wall(parent_route)
    require(pass_out[:2] == one_out[:2] == page_out[:2], "the unsegmented host-codes pass differs from the one-pass path")
    del whole
    hits = replay_single(seg_out[1], seg_out[0], thr, k, ws, n, 50)
    t0 = time.perf_counter()
    host = HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r)
    n_host = host_record_check(host, torch.from_numpy(codes), thr, seg_out[0], seg_out[1], hits, "the long record")
    require(len(hits) > 0 and any(abs(h.cmi - (seg - genes[STRADDLE_GENE].shape[0] // 2)) < ws for h in hits),
            "no hit on the gene straddling the first segment boundary")
    print(f"long record {n} bp, chunk_windows {engine.chunk}, {n_segs} segments of {seg} windows: segmented (host codes) "
          f"{seg_s:.3f} s, peak device memory {mem(seg_peak)}, K1 {seg_launch['fused_record_bitmaps']} launches, "
          f"K2 {seg_launch['match_counts']}; one pass (device tensor) {one_s:.3f} s, peak {mem(one_peak)}, "
          f"K1 {one_launch['fused_record_bitmaps']}, K2 {one_launch['match_counts']} [{label}]")
    print(f"long record unsegmented (chunk_windows {-(-nw // (2 * engine.rspan)) * engine.rspan}): host codes in one "
          f"pass {pass_s:.3f} s, then {pass2_s:.3f} s, peak {mem(pass_peak)}, K1 {pass_launch['fused_record_bitmaps']}, "
          f"K2 {pass_launch['match_counts']} (first call, pinned buffers grown: {cold_s:.3f} s, peak {mem(cold_peak)}); "
          f"host zero-pad and pageable copy, then one pass (the route before pinned staging) {page_s:.3f} s, then "
          f"{page2_s:.3f} s, peak {mem(page_peak)} [{label}]")
    print(f"long record: (dist0, {len(seg_out[1])} stream entries) equal on all paths; {len(hits)} hits equal the int64 "
          f"host engine's over the whole record ({n_host} host stream entries, {time.perf_counter() - t0:.3f} s), one "
          f"straddling the segment boundary [{label}]")
    if on_card:
        require(seg_launch["fused_record_bitmaps"] == 2 * n_segs and seg_launch["match_counts"] > 0
                and seg_launch["run_reduce_multi"] > 0, f"the segmented path did not run K1 once a segment, K2 and R1: {seg_launch}")

    # --- mine_genome on the segmented path: killed after 3 segments, resumed --
    rec = FastaRecord("long", np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes(), _codes=codes)
    full = mine_genome([rec], profile, thr=thr, engine=engine, get_hit_loci=True)
    require(len(full.hits) == len(hits), f"mine_genome found {len(full.hits)} hits, the replay {len(hits)}")
    ckpt = str(ctx["tmp"] / "long.ckpt")
    dying = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device, chunk_windows=ctx["long_chunk"])
    real = dying._segmented_bitmaps

    def killer(codes_, nw_, thr_int, tracker=None):
        orig = tracker.done_segment

        def done(si, words, fp):
            orig(si, words, fp)
            if si + 1 >= 3:
                raise KeyboardInterrupt("killed by chip_smoke")

        tracker.done_segment = done
        return real(codes_, nw_, thr_int, tracker)

    dying._segmented_bitmaps = killer
    sync()
    t0 = time.perf_counter()
    try:
        mine_genome([rec], profile, thr=thr, engine=dying, get_hit_loci=True, checkpoint_path=ckpt)
    except KeyboardInterrupt:
        pass
    else:
        raise SmokeFailure("the long record's run was not killed")
    kill_s = time.perf_counter() - t0
    with open(ckpt) as fh:
        saved = json.load(fh)
    require(saved["seg_record"] == 0 and saved["seg_next"] == 3, f"the killed run saved segment {saved['seg_next']}")
    n_bytes = os.path.getsize(ckpt)
    got, (resume_ms, res) = counted(lambda: clock(
        lambda: mine_genome([rec], profile, thr=thr, engine=engine, get_hit_loci=True, checkpoint_path=ckpt), sync))
    require([(h.description, h.seq) for h in res.hits] == [(h.description, h.seq) for h in full.hits]
            and res.hit_loci == full.hit_loci, "the resumed long record's hits differ from the uninterrupted run's")
    require(not os.path.exists(ckpt), "the resumed long record left its checkpoint behind")
    if on_card:
        require(got["fused_record_bitmaps"] == 2 * (n_segs - 3),
                f"the resumed run did not scan only the {n_segs - 3} remaining segments: {got}")
    print(f"long record checkpoint: killed after 3 of {n_segs} segments in {kill_s:.3f} s, checkpoint {n_bytes} bytes; "
          f"resumed in {resume_ms / 1e3:.3f} s, K1 {got['fused_record_bitmaps']} launches (2 a segment), "
          f"{len(res.hits)} hits equal the uninterrupted run's, file removed [{label}]")
    del rec, codes, host

    # --- the sharded engines over 1 and 4 logical shards of one device -----------
    # at the default chunk_windows, as devices=N builds them: a record is cut
    # into n_dev shards of equal span whatever its length
    clusters, cthrs = ctx["clusters"], list(map(float, ctx["cthrs"]))
    one = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    cone = ClusterScanEngine(clusters.profiles, k=6, device=device)
    first = device if device.type == "cpu" else torch.device("cuda", 0)
    meshes = {n_dev: make_mesh(devices=[first] * n_dev) for n_dev in (1, 4)}
    records = [*ctx["contigs"], ctx["short_contig"]]

    def shards_of(eng, name):
        """Run ``eng`` over ``records`` with its per-shard bitmap pass
        (method ``name``) counted: (results, shards launched per record)."""
        real, seen = getattr(eng, name), []

        def shard(*a, **kw):
            seen[-1] += 1
            return real(*a, **kw)

        setattr(eng, name, shard)
        try:
            out = []
            for c in records:
                seen.append(0)
                out.append(eng.record_streams(c, cthrs) if name == "_bitmaps" else eng.record_stream(c, thr)[:2])
            return out, seen
        finally:
            delattr(eng, name)

    for n_dev, mesh in meshes.items():
        sh = ShardedScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=mesh)
        got, (ms, (streams, shards)) = counted(lambda: clock(lambda: shards_of(sh, "_record_bitmap"), sync))
        one_ms, want = clock(lambda: [one.record_stream(c, thr)[:2] for c in records], sync)
        require(streams == want, f"ShardedScanEngine over {n_dev} shards differs from the one-device engine")
        require(shards == [n_dev] * len(records), f"ShardedScanEngine over {n_dev} shards launched {shards} a record")
        line = f"ShardedScanEngine over {n_dev} logical shards of {first}, chunk_windows {sh.chunk}: {len(records)} " \
               f"records ({sum(c.shape[0] for c in records)} bp) in {ms / 1e3:.3f} s (one-device engine " \
               f"{one_ms / 1e3:.3f} s), shards launched a record {shards}, streams equal the one-device engine's; " \
               f"K1 {got['fused_record_bitmaps']}, K2 {got['match_counts']}"
        if n_dev == 4:
            csh = ShardedClusterScanEngine(clusters.profiles, k=6, mesh=mesh)
            cgot, (cms, (cstreams, cshards)) = counted(lambda: clock(lambda: shards_of(csh, "_bitmaps"), sync))
            cone_ms, cwant = clock(lambda: [cone.record_streams(c, cthrs) for c in records], sync)
            require(cstreams == cwant, "ShardedClusterScanEngine over 4 shards differs from the one-device engine")
            require(cshards == [n_dev] * len(records), f"ShardedClusterScanEngine launched {cshards} shards a record")
            line += (f"; ShardedClusterScanEngine {cms / 1e3:.3f} s (one-device {cone_ms / 1e3:.3f} s), shards "
                     f"{cshards}, streams equal, K3 {cgot['fused_cluster_record_bitmaps']}, K5 "
                     f"{cgot['codes_pair_multi']}, K8 {cgot['lookup_roundtrip']}, K2 {cgot['match_counts']}")
            if on_card:
                require(cgot["fused_cluster_record_bitmaps"] > 0 and cgot["codes_pair_multi"] > 0
                        and cgot["lookup_roundtrip"] > 0 and cgot["run_reduce_multi"] > 0,
                        f"a kernel of the sharded cluster path never launched: {cgot}")
        print(line + f" [{label}]")
        if on_card:
            require(got["fused_record_bitmaps"] > 0 and got["match_counts"] > 0 and got["run_reduce_multi"] > 0,
                    f"a kernel of the sharded single-profile path never launched: {got}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, (ms, out) = counted(lambda: clock(
            lambda: kt.find_genes(str(ctx["fasta"]), REF, verbose=False, do_return_hit_loci=True, devices=1,
                                  device=device), sync))
        want_hits, want_loci = ctx["uninterrupted"]["single"]
        require([(h.description, h.seq) for h in out[0]] == [(h.description, h.seq) for h in want_hits]
                and out[1] == want_loci, "find_genes(devices=1) differs from find_genes")
        cgot, (cms, cout) = counted(lambda: clock(
            lambda: kt.find_genes_cluster_mode(str(ctx["cluster_fasta"]), REF, verbose=False, do_return_hit_loci=True,
                                               devices=1, device=device), sync))
        want_hits, want_loci = ctx["uninterrupted"]["cluster"]
        require([(h.description, h.seq) for h in cout[0]] == [(h.description, h.seq) for h in want_hits]
                and cout[1] == want_loci, "find_genes_cluster_mode(devices=1) differs from find_genes_cluster_mode")
    print(f"find_genes(devices=1) {ms / 1e3:.3f} s, {len(out[0])} hits, and find_genes_cluster_mode(devices=1) "
          f"{cms / 1e3:.3f} s, {len(cout[0])} hits, equal the API phases' [{label}]")

    # --- a one-rank process group: the all-gather path ------------------------------
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", num_processes=1, process_id=0, device=device)
    try:
        mesh = make_mesh(device=device, devices=[first])
        require(mesh.distributed, "the mesh after initialize_distributed spans no process group")
        sh = ShardedScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=mesh)
        require(sh.record_stream(records[0], thr)[:2] == one.record_stream(records[0], thr)[:2],
                "the sharded pass over a one-rank process group differs from the one-device engine")
        print(f"one-rank process group ({dist.get_backend()}): the sharded pass's all-gather ran, stream equal [{label}]")
    finally:
        dist.destroy_process_group()

    # --- more than one card ---------------------------------------------------------------
    if on_card and torch.cuda.device_count() > 1:
        got, (ms, out) = counted(lambda: clock(
            lambda: kt.find_genes(str(ctx["fasta"]), REF, verbose=False, do_return_hit_loci=True, devices=2), sync))
        want_hits, want_loci = ctx["uninterrupted"]["single"]
        require([h.description for h in out[0]] == [h.description for h in want_hits] and out[1] == want_loci,
                "find_genes(devices=2) differs from find_genes")
        print(f"find_genes(devices=2) over two cards {ms / 1e3:.3f} s, hits equal [{label}]")
    else:
        print(f"real multi-card sharding not exercised: {torch.cuda.device_count() if on_card else 0} card(s) "
              f"present [{label}]")

    # --- the checkpoint's cost on many records -------------------------------------
    n_rec = min(256, ctx["fragments"])
    frags = np.concatenate(ctx["contigs"])[: n_rec * FRAGMENT_BP].reshape(n_rec, FRAGMENT_BP)
    frecs = [FastaRecord(f"frag{i}", np.frombuffer(b"ACGT", dtype=np.uint8)[f].tobytes(), _codes=f)
             for i, f in enumerate(frags)]

    def mine(ckpt=None):
        return mine_genome_clusters(frecs, clusters.profiles, thr_vec=cthrs, buff=100, get_hit_loci=True,
                                    engine=cone, checkpoint_path=ckpt)

    mine()  # warm-up
    from kmergma_tpu_torch.utils.checkpoint import ScanCheckpoint

    writes: list = []
    real_write = ScanCheckpoint._write

    def timed_write(self):
        t0 = time.perf_counter()
        real_write(self)
        writes.append(time.perf_counter() - t0)

    ckpt = str(ctx["tmp"] / "frag.ckpt")
    walls, hits = [], []
    ScanCheckpoint._write = timed_write
    try:
        for path in (None, ckpt, ckpt, None):  # in turns: the host's drift falls on both
            ms, res = clock(lambda: mine(path), sync)
            walls.append(ms / 1e3)
            hits.append([h.description for h in res.hits])
    finally:
        ScanCheckpoint._write = real_write
    require(all(h == hits[0] for h in hits), "the checkpointed fragment run's hits differ")
    print(f"checkpoint cost: mine_genome_clusters over {n_rec} fragments of {FRAGMENT_BP} bp, {len(hits[0])} hits, "
          f"in turns without / with / with / without checkpoint_path: {' / '.join(f'{w:.3f}' for w in walls)} s; "
          f"{len(writes)} file writes of {sum(writes) / len(writes) * 1e3:.3f} ms each on average, "
          f"{sum(writes) / 2:.3f} s a run [{label}]")
    return total


def captured_alignments(call):
    """(``call()``, [(query, windows, gap_open, gap_extend)]): every batch
    the single-profile and strobemer miners hand their aligner in the call,
    taken at the router they call, which then runs as it would."""
    import kmergma_tpu_torch.models.miner as miner
    import kmergma_tpu_torch.models.strobe_miner as strobe_miner

    batches = []
    real = miner.align_hits_batch

    def spy(query, subjects, gap_open=-69, gap_extend=-1, device="cuda"):
        batches.append((query, list(subjects), gap_open, gap_extend))
        return real(query, subjects, gap_open, gap_extend, device=device)

    miner.align_hits_batch = strobe_miner.align_hits_batch = spy
    try:
        return call(), batches
    finally:
        miner.align_hits_batch = strobe_miner.align_hits_batch = real


def a1_io(m: int, lengths: list, cap: int) -> dict:
    """A1's work on one batch, as the function needs it: the bytes it must
    move (the query's NUC44 rows and letters, the subjects' letters and
    offsets in; a row of score, count, endpoint and ``cap`` runs out a
    subject) and the DP's integer operations (``DP_OPS_PER_CELL`` a cell)."""
    cells = sum(m * n for n in lengths)
    io = 61 * m + sum(lengths) + 16 * len(lengths) + 8 + 4 * (3 + cap) * len(lengths)
    return {"bytes": io, "ops": DP_OPS_PER_CELL * cells}


#: A1's CUDA-event times in PR 12 (one warp a subject walking the query
#: rows, TL in device memory), ms a call: the batch it was measured on
A1_PR12_MS = {"single": 0.6253, "strobe": 0.7339, "cut": 1.5936}


def a1_stages(q: str, wins: list, go: int, ge: int, device, sync, reps: int = 3) -> tuple[dict, list]:
    """(median ms of each stage of ``semiglobal_align_device`` by host
    clock, the AlignResults): the letters' translation, the copies to the
    device, A1 (``align_cigar``), the one copy back and the AlignResults'
    building; a hit past ``RLE_CAP`` would run A1 again, which these
    batches never need (checked)."""
    from kmergma_tpu_torch.ops import align_device as tad

    names = ("letters", "h2d", "A1", "d2h", "results")
    runs = []
    for _ in range(reps):
        ms = {}
        t0 = time.perf_counter()
        a, b_flat, lengths = tad._letters(q, wins)
        ms["letters"] = (time.perf_counter() - t0) * 1e3
        ms["h2d"], (a_sub, a_idx, b_dev) = clock(lambda: tad._to_device(a, b_flat, device), sync)
        ms["A1"], out = clock(lambda: tad.align_cigar(a_sub, a_idx, b_dev, lengths, go, ge), sync)
        ms["d2h"], rows = clock(lambda: tad._rows(out[0], out[1].shape[1]).cpu().numpy(), sync)
        t0 = time.perf_counter()
        res = tad._results(rows)
        ms["results"] = (time.perf_counter() - t0) * 1e3
        require(all(r is not None for r in res), "a hit of the aligner phase passed RLE_CAP")
        runs.append(ms)
    return {k: statistics.median(r[k] for r in runs) for k in names}, res


def a1_launch_info(m: int, max_n: int, smem: bool, on_card: bool) -> dict:
    """A1's launch shape for a query of m rows and subjects up to max_n
    letters (rows a lane, strips, shared memory a block, resident blocks
    an SM, registers and spill bytes a thread), from the kernel library;
    the layout alone on the CPU."""
    from kmergma_tpu_torch.ops import align_device as tad

    r, strips, _stride, _pitch = tad._layout(m)
    info = {"rows_per_lane": r, "strips": strips, "smem_bytes": tad._smem_bytes(m, max_n) if smem else None}
    if on_card:
        import ctypes

        from kmergma_tpu_torch import _kernels

        out = (ctypes.c_int * 6)()
        _kernels.check(_kernels.load().kmg_align_launch_info(m, max_n, int(smem), out), "kmg_align_launch_info")
        info.update(rows_per_lane=out[0], smem_bytes=out[1], blocks_per_sm=out[2], registers=out[3],
                    spill_bytes=out[4], strips=out[5])
    return info


def aligner_phase(ctx) -> dict:
    """The device aligner: A1 against its twins on the card (scores, JAX
    runs, run counts, endpoints, CIGAR runs and their counts) and its
    AlignResults against the native DP's on the single-profile and strobe
    API cells' hit windows (as the miners batch them) and on a batch of
    windows cut around every planted gene, then on the edge shapes (a
    subject past 511 letters, one whose decisions pass the shared-memory
    budget, a query past one strip, m = 0 and n = 0); ``find_genes`` and
    ``strobemer_find_genes`` by default (A1 on a card's batches of 16 or
    more) against their runs under ``KMERGMA_ALIGN_DEVICE=0``, the host
    DP; A1's times (wrapper and device), its launch shape, the
    stages of ``semiglobal_align_device`` and the native DP's times (one
    window, the thread scaling).  Returns A1's kernel row."""
    import os
    import statistics as st

    import numpy as np
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.bench import _env_set
    from kmergma_tpu_torch.ops import align_device as tad
    from kmergma_tpu_torch.ops.align import semiglobal_align_batch
    from kmergma_tpu_torch.utils import native

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    tad.semiglobal_align_device.overflowed = 0

    def api(route: str):
        """((hits, loci, alignments), batches) of find_genes and of
        strobemer_find_genes, ``KMERGMA_ALIGN_DEVICE`` set to ``route``
        ("" is the default route)."""
        kwargs = dict(verbose=False, do_return_hit_loci=True, do_return_align=True, device=device)
        with warnings.catch_warnings(), _env_set("KMERGMA_ALIGN_DEVICE", route):
            warnings.simplefilter("ignore")
            return (captured_alignments(lambda: kt.find_genes(str(ctx["fasta"]), REF, **kwargs)),
                    captured_alignments(lambda: kt.strobemer_find_genes(str(ctx["fasta"]), REF, **kwargs)))

    def same(a, b) -> bool:
        return ([(h.description, h.seq) for h in a[0]] == [(h.description, h.seq) for h in b[0]] and a[1] == b[1]
                and [(x.score, x.cigar) for x in a[2]] == [(x.score, x.cigar) for x in b[2]])

    (want_single, single_b), (want_strobe, strobe_b) = api("0")
    ctx["launches"].reset()
    t0 = time.perf_counter()
    (got_single, _), (got_strobe, _) = api("")
    default_s = time.perf_counter() - t0
    launches = ctx["launches"].read()["align_dp"]
    require(same(got_single, want_single) and same(got_strobe, want_strobe),
            "find_genes or strobemer_find_genes by default differs from its run under KMERGMA_ALIGN_DEVICE=0")
    if on_card:
        require(launches > 0, "A1 never launched on the default route")
    print(f"aligner: find_genes and strobemer_find_genes by default in {default_s:.3f} s: hits, loci and alignments "
          f"equal the runs' under KMERGMA_ALIGN_DEVICE=0, the host DP ({len(want_single[0])} and "
          f"{len(want_strobe[0])} hits), A1 {launches} launches [{label}]")

    # the API cells' windows (every record's batch of one call), and a batch
    # cut around every planted gene
    def joined(bs):
        return (bs[0][0], [w for b in bs for w in b[1]], bs[0][2], bs[0][3])

    query = single_b[0][0]
    width = len(query) + 100
    plant_every = ctx["plant_every"]
    cut = []
    for codes in ctx["contigs"]:
        for pos in range(plant_every // 2, codes.shape[0] - plant_every // 2 + 1, plant_every):
            for sh in ALIGN_SHIFTS:
                lo = min(max(pos - 50 + sh, 0), codes.shape[0] - width)
                cut.append(np.frombuffer(b"ACGT", np.uint8)[codes[lo : lo + width]].tobytes().decode())
    cases = {"single": joined(single_b), "strobe": joined(strobe_b), "cut": (query, cut, -69, -1)}
    if on_card:
        require(len(cut) >= 1_000, f"the cut batch has {len(cut)} windows")

    def a1_inputs(q, wins):
        a, b_flat, lengths = tad._letters(q, wins)
        return (*tad._to_device(a, b_flat, device), lengths)

    def a1_err(a_sub, a_idx, b_flat, lengths, go, ge, cap=None) -> int:
        """A1's two outputs against their twins on the same inputs."""
        cap = tad.RLE_CAP if cap is None else cap
        rle = tad.align_dp(a_sub, b_flat, lengths, go, ge, cap)
        cig = tad._rows(tad.align_cigar(a_sub, a_idx, b_flat, lengths, go, ge, cap)[0], cap)
        want = tad._align_dp_plain(a_sub, b_flat, lengths, go, ge, cap)
        return max(max_err(*zip(rle, want)), max_err((cig, tad._align_cigar_plain(a_sub, a_idx, b_flat, lengths, go, ge,
                                                                                      cap))))

    shapes, err = {}, 0
    for name, (q, wins, go, ge) in cases.items():
        a_sub, a_idx, b_flat, lengths = a1_inputs(q, wins)
        m = a_sub.shape[0]
        rle_ms, _ = kernel_ms(lambda: tad.align_dp(a_sub, b_flat, lengths, go, ge), on_card)
        ms, out = kernel_ms(lambda: tad.align_cigar(a_sub, a_idx, b_flat, lengths, go, ge), on_card)
        dev_ms = (queued_device_ms(lambda: tad.align_cigar(a_sub, a_idx, b_flat, lengths, go, ge)) if on_card
                  else None)
        plain_ms, twin = kernel_ms(lambda: tad._align_cigar_plain(a_sub, a_idx, b_flat, lengths, go, ge, tad.RLE_CAP),
                                   on_card, reps=1, windows=3)
        e = max(a1_err(a_sub, a_idx, b_flat, lengths, go, ge), max_err((tad._rows(out[0], tad.RLE_CAP), twin)))
        err = max(err, e)
        require(e == 0, f"A1 differs from its twins on the {name} windows (max_abs_err {e})")
        stages, res = a1_stages(q, wins, go, ge, device, sync)
        wall, got = clock(lambda: tad.semiglobal_align_device(q, wins, go, ge, device=device), sync)
        nat = [clock(lambda: semiglobal_align_batch(q, wins, go, ge), sync) for _ in range(3)]
        host = [(x.score, x.cigar) for x in nat[-1][1]]
        require([(x.score, x.cigar) for x in got] == host and [(x.score, x.cigar) for x in res] == host,
                f"the device aligner's AlignResults differ from the native DP's on the {name} windows")
        if name == "cut":
            cut_ms, cut_plain_ms = ms, plain_ms
        io = a1_io(m, lengths, tad.RLE_CAP)
        b_ms, b_by = bound(io["bytes"], io["ops"])
        n_runs = out[2].cpu().numpy()
        launch = a1_launch_info(m, max(lengths), True, on_card)
        shapes[name] = {"windows": len(wins), "query": m, "window_bp": [min(lengths), max(lengths)],
                        "gap": [go, ge], "ms": float(ms), "ms_min": ms.min, "rle_ms": float(rle_ms),
                        "rle_ms_min": rle_ms.min, "device_ms": dev_ms,
                        "plain_ms": float(plain_ms), "bound_ms": b_ms, "bound_by": b_by, "bytes": io["bytes"],
                        "launch": launch, "device_wall_ms": wall, "stages_ms": stages,
                        "native_ms": st.median(t for t, _ in nat), "max_cigar_runs": int(n_runs.max()), "io": io}
        dev_txt = "not measured (CPU)" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"A1 on the {name} windows: {len(wins)} of {min(lengths)}-{max(lengths)} bp against a {m} bp query "
              f"({go}/{ge}), max {int(n_runs.max())} CIGAR runs: CIGAR runs {ms:.4f} ms a call (fastest window "
              f"{ms.min:.4f}), JAX runs {rle_ms:.4f} (fastest {rle_ms.min:.4f}), device {dev_txt}; PR 12 "
              f"{A1_PR12_MS[name]:.4f}; twins {plain_ms:.3f} ms, max_abs_err {e}; bound {b_ms:.4f} ms ({b_by}), "
              f"{io['bytes']} B moved [{label}]")
        print(f"A1 launch on the {name} windows: {launch} [{label}]")
        print(f"semiglobal_align_device on the {name} windows {wall:.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f" ms; native DP {shapes[name]['native_ms']:.3f} ms; AlignResults equal [{label}]")

    # the edge shapes: subjects past 511 letters and past the shared-memory
    # budget (the device-memory layout), a query past one strip, m = 0, n = 0
    rng = np.random.default_rng(7)

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    long_q = rand(700)
    edges = {
        "subjects of 600 and 1989 letters": (query, cut[:3] + [rand(600), cut[0][:50] + query + rand(1650)]),
        "a 700-letter query (two strips)": (long_q, [long_q[:400], rand(389), long_q[500:] + rand(80), "",
                                                     long_q[250:450]]),
        "m = 0": ("", [cut[0], "", "ACG"]),
        "n = 0": (query, ["", cut[1], ""]),
    }
    budget_m, budget_n = len(query), 1989
    require(tad._smem_bytes(budget_m, budget_n) > tad.SMEM_BUDGET_BYTES >= tad._smem_bytes(len(query), 600),
            "the edge shapes miss the device-memory layout")
    ctx["launches"].reset()
    want_launches, routes = 0, []
    for what, (q, wins) in edges.items():
        a_sub, a_idx, b_flat, lengths = a1_inputs(q, wins)
        plan = tad._launch_plan(lengths, a_sub.shape[0])
        want_launches += 8 * len(plan)  # two gap models, two caps, two wrappers
        routes.append(f"{what}: " + " + ".join(f"{sel.size} in {'shared' if woff is None else 'device'} memory"
                                                for sel, woff in plan))
        for go, ge in ((-69, -1), (-5, -2)) if on_card else ((-69, -1),):  # the CPU rehearsal: one gap model
            e = a1_err(a_sub, a_idx, b_flat, lengths, go, ge)
            e = max(e, a1_err(a_sub, a_idx, b_flat, lengths, go, ge, cap=4))
            err = max(err, e)
            require(e == 0, f"A1 differs from its twins on {what} ({go}/{ge}, max_abs_err {e})")
    edge_launches = ctx["launches"].read()["align_dp"]
    require(all(f"{x} memory" in routes[k] for k in (0, 1) for x in ("shared", "device")),
            f"the edge shapes miss a layout: {routes}")
    if on_card:
        require(edge_launches == want_launches, f"A1 launched {edge_launches} times on the edge shapes, not {want_launches}")
    print(f"A1 edge shapes against the twins, both outputs, {'-69/-1 and -5/-2' if on_card else '-69/-1'}, cap 256 and 4: "
          f"{'; '.join(routes)}: max_abs_err 0; {edge_launches} launches (the 1989-letter subject's launch: "
          f"{a1_launch_info(budget_m, budget_n, False, on_card)}) [{label}]")

    # the native DP: one window a call, and the large batch by its threads
    # (it runs min(8, os.cpu_count()) of them)
    q, wins, go, ge = cases["cut"]
    real_cpu_count = os.cpu_count
    one = [clock(lambda: semiglobal_align_batch(q, wins[:1], go, ge), sync)[0] for _ in range(10)]
    dev_one = [clock(lambda: tad.semiglobal_align_device(q, wins[:1], go, ge, device=device), sync)[0] for _ in range(10)]
    shapes["cut"]["device_one_window_ms"] = st.median(dev_one)
    threads = {}
    with_lib = native.get_lib() is not None
    cores = os.cpu_count()
    for n_threads in (1, 2, 4, 8):
        os.cpu_count = lambda n=n_threads: n
        try:
            threads[n_threads] = st.median(clock(lambda: semiglobal_align_batch(q, wins, go, ge), sync)[0]
                                           for _ in range(2))
        finally:
            os.cpu_count = real_cpu_count
    print(f"native DP ({'the native library' if with_lib else 'no native library: the NumPy batch'}): one window a "
          f"call {st.median(one):.3f} ms (median of 10; semiglobal_align_device {st.median(dev_one):.3f} ms); "
          f"{len(wins)} windows on 1 / 2 / 4 / 8 threads "
          f"{' / '.join(f'{threads[t]:.2f}' for t in (1, 2, 4, 8))} ms; {cores} cores; overflowed hits "
          f"{tad.semiglobal_align_device.overflowed} [{label}]")
    big = shapes["cut"]
    return entry("align_dp", "align_dp.cu", "kmergma_tpu/ops/align_device.py:167", launches, err,
                 cut_ms, cut_plain_ms, big["io"]["bytes"], big["io"]["ops"],
                 shapes={k: {kk: vv for kk, vv in v.items() if kk != "io"} for k, v in shapes.items()},
                 native_one_window_ms=st.median(one), native_threads_ms=threads,
                 overflowed=tad.semiglobal_align_device.overflowed)


def tp_phase(ctx) -> None:
    """The profile-sharded engine: ``TPScanEngine`` over 1 and 4 logical
    shards of the first device on the genome's first contig, with the
    reference set's profile and the API's threshold at each k of
    ``TP_CASES``: its streams against
    the one-device ``ScanEngine``'s, its dist0 and replayed hits against the
    int64 host engine's over the whole record, K6 and K2 launched and K1
    not, each wall beside the one-device engine's and the table bytes a
    device holds.  Over four cards where they are present, with the
    miner's own route to it.  Then ScanEngine at ``ctx["max_k"]`` (15, its
    K codes' limit) on one device, against TPScanEngine."""
    import numpy as np
    import torch

    from kmergma_tpu_torch.models.miner import _default_engine, mine_genome
    from kmergma_tpu_torch.models.state_machine import replay_single
    from kmergma_tpu_torch.ops.kmers import rolling_kmer_codes as host_kmer_codes
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_host import HostScanEngine
    from kmergma_tpu_torch.parallel.mesh import make_mesh
    from kmergma_tpu_torch.parallel.tp_lookup import TPScanEngine
    from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

    device, on_card, sync, label = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"]
    record = ctx["contigs"][0]
    n = record.shape[0]
    first = device if device.type == "cpu" else torch.device("cuda", 0)
    four = on_card and torch.cuda.device_count() >= 4

    def walls(eng, thr):
        times, out = timed_calls(lambda: eng.record_stream(record, thr)[:2], sync, ctx["runs"])
        return statistics.median(times), out

    for k, thr in TP_CASES:
        p = gen_ref_ws_cons(REF, k)
        ws, r = p.windowsize, p.n_records
        one_s, want = walls(ScanEngine(p.sum_kfv, k=k, ws=ws, r=r, device=device), thr)
        host_ms, (d0_h, stream_h, _) = clock(lambda: HostScanEngine(p.sum_kfv, k=k, ws=ws, r=r).record_stream(record, thr),
                                             sync)
        hits_h = replay_single(stream_h, d0_h, thr, k, ws, n, 50)
        if on_card:  # the rehearsal's short contig holds two genes far from the mean profile
            require(len(hits_h) > 0, f"no hits at k = {k} on the planted contig")
        meshes = {f"{n_dev} logical shards of {first}": make_mesh(devices=[first] * n_dev) for n_dev in (1, 4)}
        if four:
            meshes["4 cards"] = make_mesh(4)
        line = []
        for what, mesh in meshes.items():
            tp = TPScanEngine(p.sum_kfv, k=k, ws=ws, r=r, mesh=mesh)
            ctx["launches"].reset()
            tp_s, got = walls(tp, thr)
            launches = ctx["launches"].read()
            require(got == want, f"TPScanEngine over {what} at k = {k} differs from the one-device engine")
            require(got[0] == d0_h and replay_single(got[1], got[0], thr, k, ws, n, 50) == hits_h,
                    f"TPScanEngine over {what} at k = {k} differs from the int64 host engine")
            if on_card:
                require(launches["pair_ab_from_kcodes"] > 0 and launches["match_counts"] > 0
                        and launches["fused_record_bitmaps"] == 0,
                        f"TPScanEngine over {what} at k = {k} launched {launches}")
            line.append(f"over {what} {tp_s:.4f} s, {tp.shard_bytes} table bytes a device, K6 "
                        f"{launches['pair_ab_from_kcodes']}, K2 {launches['match_counts']}, K1 "
                        f"{launches['fused_record_bitmaps']}")
        print(f"TPScanEngine k = {k} (4^{k} bins, ws {ws}, threshold {thr}), {n} bp contig, median of {ctx['runs']}: "
              f"{'; '.join(line)}; one-device ScanEngine {one_s:.4f} s ({4 * 4**k} table bytes); int64 host engine "
              f"{host_ms / 1e3:.3f} s; {len(want[1])} stream entries and {len(hits_h)} hits equal on every engine "
              f"[{label}]")
        if four:  # the miner takes the sharded engine on its own
            rec = FastaRecord("contig0", np.frombuffer(b"ACGT", np.uint8)[record].tobytes(), _codes=record)
            routed = _default_engine(p, "cuda")
            require(isinstance(routed, TPScanEngine) and len(routed.mesh.devices) == 4,
                    f"the miner did not route k = {k} to TPScanEngine over 4 cards: {type(routed).__name__}")
            got = mine_genome([rec], p, thr=thr, device="cuda")
            want_hits = mine_genome([rec], p, thr=thr, engine=ScanEngine(p.sum_kfv, k=k, ws=ws, r=r), device="cuda")
            require([h.description for h in got.hits] == [h.description for h in want_hits.hits],
                    f"mine_genome's own route at k = {k} differs from one card")
            print(f"mine_genome k = {k} routed to TPScanEngine over 4 cards on its own: {len(got.hits)} hits equal one "
                  f"card's [{label}]")
    if not four:
        print(f"TPScanEngine over four cards not exercised: {torch.cuda.device_count() if on_card else 0} card(s) "
              f"present [{label}]")

    # the largest k of ScanEngine's int32 K codes, on one device: the
    # reference set's summed profile, built sparse on the host
    k = ctx["max_k"]
    p6 = ctx["profile"]
    ws, r = p6.windowsize, p6.n_records
    s = np.zeros(4**k, dtype=np.int32)
    for rec in as_records(REF):
        np.add.at(s, host_kmer_codes(rec.codes, k), 1)
    thr = 10.0  # the planted genes near 4, the background near 13 at k = 15
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    one_ms, want = clock(lambda: ScanEngine(s, k=k, ws=ws, r=r, device=device).record_stream(record, thr)[:2], sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tp_ms, got = clock(lambda: TPScanEngine(s, k=k, ws=ws, r=r, mesh=make_mesh(devices=[first] * 4))
                       .record_stream(record, thr)[:2], sync)
    tp_peak = torch.cuda.max_memory_allocated() if on_card else 0
    require(got == want and (len(want[1]) > 0 or not on_card), f"TPScanEngine at k = {k} differs from ScanEngine")
    print(f"largest k of ScanEngine (int32 K codes): k = {k}, {4 * 4**k} table bytes on one device; set-up and "
          f"{n} bp in {one_ms / 1e3:.3f} s, peak {peak} B; TPScanEngine over 4 logical shards "
          f"{tp_ms / 1e3:.3f} s, peak {tp_peak} B; {len(want[1])} stream entries equal [{label}]")


def tp_cards(device, label: str = "", contig_bp: int = 16_000_000, runs: int = 3, max_k: int = MAX_K) -> None:
    """The TP phase alone on a host with four cards (``python3 chip_smoke.py
    --tp-cards``): ``TPScanEngine`` over logical shards of the first card
    and over the four cards, and the miner's own route to it, each against
    the one-device and the int64 host engines, on the first contig of the
    synthetic genome."""
    import torch

    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.utils.fasta import as_records

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        require(torch.cuda.device_count() >= 4, f"--tp-cards needs four cards, {torch.cuda.device_count()} present")
        build_kernels(label)
    contigs = synthetic_genome(1, contig_bp, 500_000, [rec.codes for rec in as_records(REF)])
    tp_phase(dict(device=device, on_card=on_card, sync=torch.cuda.synchronize if on_card else (lambda: None),
                  label=label, runs=runs, contigs=contigs, launches=Launches(), max_k=max_k,
                  profile=gen_ref_ws_cons(REF, 6)))


def two_axis_tile_dists(record, profiles, t: int, n_tiles: int) -> list:
    """Each profile's exact distances over ``n_tiles`` tiles of ``t``
    windows (int64[n_tiles, t]) from the int64 host engine: over the record
    zero-padded past its end, as ``make_tiles`` pads it, and for the whole
    padding tiles over one all-zero tile."""
    import numpy as np

    from kmergma_tpu_torch.ops.scan_host import HostScanEngine

    ws = TWO_AXIS_WS
    real = -(-(record.shape[0] - ws + 1) // t)
    padded = np.zeros(real * t + ws - 1, dtype=np.int8)
    padded[: record.shape[0]] = record
    out = []
    for p in profiles:
        host = HostScanEngine(p, k=6, ws=ws, r=TWO_AXIS_R)
        d = np.empty((n_tiles, t), dtype=np.int64)
        d[:real] = host._dists(padded).reshape(real, t)
        d[real:] = host._dists(np.zeros(t + ws - 1, dtype=np.int8))
        out.append(d)
    return out


def two_axis_oracle(tile_dists: list, thrs, cap: int) -> tuple:
    """The two-axis step's six outputs from each profile's tile distances
    (``two_axis_tile_dists``), derived in numpy: a window is a candidate
    where it or the window before lies below the threshold, and a tile's
    buffer holds its first ``cap`` candidates, then 0."""
    import numpy as np

    out = [[] for _ in range(6)]
    for d, thr in zip(tile_dists, thrs):
        below = d < int(thr)
        mask = below.copy()
        mask[:, 1:] |= below[:, :-1]
        rows, cols = np.nonzero(mask)  # row-major: each row's windows in order
        rank = np.arange(rows.shape[0]) - np.searchsorted(rows, rows)
        keep = rank < cap
        idx = np.zeros((d.shape[0], cap), dtype=np.int64)
        idx[rows[keep], rank[keep]] = cols[keep]
        for o, v in zip(out, (d[:, 0], mask.sum(axis=1), idx, np.take_along_axis(d, idx, axis=1), below[:, 0],
                              below[:, -1])):
            o.append(v)
    return tuple(np.stack(o) for o in out)


def two_axis_phase(ctx, cards: bool = False) -> dict:
    """The two-axis step ``sharded_cluster_scan_step`` on the genome's first
    contig, cut by ``make_tiles`` into tiles of ``TWO_AXIS_TILE`` windows,
    against four profiles (profile j summed over the reference records
    with index j mod 4), in two threshold cases: each profile's distance at
    rank ceil(nw / 10,000), and 2^30 (every window a candidate, the buffers
    full).  On every mesh of ``TWO_AXIS_MESHES``, over logical shards of the
    first device (``cards``: (1 x 1) on the first card and the four-device
    meshes over four cards), all six outputs equal the int64 host
    oracle's (``two_axis_oracle``), K2 launched once a device and K1 and
    K3 not, each wall (median of ``runs``) beside its device time and peak
    memory.  K2 against its twin at the step's shape, and the step over a
    one-rank process group (NCCL on the card).  Returns the launches of
    every kernel in the counted calls, and K2's row at the step's shape."""
    import math
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import rolling_kmer_codes
    from kmergma_tpu_torch.ops.scan_kernels import _match_counts_plain, match_counts
    from kmergma_tpu_torch.parallel.mesh import initialize_distributed, make_hybrid_mesh, make_mesh
    from kmergma_tpu_torch.parallel.sharded_scan import make_tiles, sharded_cluster_scan_step
    from kmergma_tpu_torch.utils.fasta import as_records

    device, on_card, sync, label, launches = ctx["device"], ctx["on_card"], ctx["sync"], ctx["label"], ctx["launches"]
    record = ctx["contigs"][0]
    t, cap, ws, r = ctx["two_axis_tile"], TWO_AXIS_CAP, TWO_AXIS_WS, TWO_AXIS_R
    first = device if device.type == "cpu" else torch.device("cuda", 0)
    refs = as_records(REF)
    profiles = np.stack([gen_ref_ws_cons(refs[j::4], 6).sum_kfv for j in range(4)]).astype(np.int32)
    nw = record.shape[0] - ws + 1
    rank = math.ceil(nw / 10_000)
    meshes = {}
    for nc, nd in TWO_AXIS_MESHES:
        if cards and nc * nd == 4:
            meshes[f"{nc} x {nd} over four cards"] = make_mesh(4, n_clusters=nc)
        else:
            meshes[f"{nc} x {nd} over {nc * nd} logical shard(s) of {first}"] = make_mesh(devices=[first] * (nc * nd),
                                                                                          n_clusters=nc)
    n_max = max(make_tiles(record, t, ws, m.shape["data"])[0].shape[0] for m in meshes.values())
    host_ms, tile_dists = clock(lambda: two_axis_tile_dists(record, profiles, t, n_max), lambda: None)
    cases = {f"rank {rank}": np.array([np.partition(d.reshape(-1)[:nw], rank)[rank] for d in tile_dists], dtype=np.int32),
             "2^30": np.full(4, 2**30, dtype=np.int32)}
    total = dict.fromkeys(launches.read(), 0)
    walls = {}
    for case, thrs in cases.items():
        oracle_ms, want = clock(lambda: two_axis_oracle(tile_dists, thrs, cap), lambda: None)
        one = None
        line = []
        for what, mesh in meshes.items():
            tiles, _ = make_tiles(record, t, ws, mesh.shape["data"])

            def step():
                return sharded_cluster_scan_step(tiles, profiles, thrs, k=6, ws=ws, r=r, cap=cap, mesh=mesh)

            times, _ = timed_calls(step, sync, ctx["runs"])
            launches.reset()
            got = step()
            sync()
            counted = launches.read()
            for name, n in counted.items():
                total[name] += n
            n_dev = len(mesh.devices)
            for i, (a, b) in enumerate(zip(got, want)):
                require(a.device == mesh.first and a.shape == (4, tiles.shape[0], *b.shape[2:])
                        and np.array_equal(a.cpu().numpy(), b[:, : tiles.shape[0]]),
                        f"two-axis step over {what}, thresholds {case}: output {i} differs from the int64 host oracle")
            if one is None:
                one = got
            require(all(torch.equal(a[:, : one[0].shape[1]].cpu(), b.cpu()) for a, b in zip(got, one)),
                    f"two-axis step over {what} differs from the (1 x 1) mesh")
            if on_card:
                require(counted["match_counts"] == n_dev and counted["fused_record_bitmaps"] == 0
                        and counted["fused_cluster_record_bitmaps"] == 0,
                        f"two-axis step over {what} launched {counted}")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                step()
                sync()
                peak = f"{torch.cuda.max_memory_allocated()} B"
                dev_ms, _ = device_ms_per_call(step, reps=3)
                dev = f"{dev_ms:.3f} ms"
            else:
                peak = dev = "not measured (CPU)"
            wall = statistics.median(times)
            walls[(case, what)] = wall
            line.append(f"{what}: {wall:.4f} s, device {dev}, peak {peak}, K2 {counted['match_counts']}, K1 "
                        f"{counted['fused_record_bitmaps']}, K3 {counted['fused_cluster_record_bitmaps']}")
        print(f"two-axis step, thresholds {case} ({int(want[1][:, : -(-nw // t)].sum())} candidates, "
              f"{int(np.minimum(want[1], cap).sum())} in the buffers), {record.shape[0]} bp in tiles of {t} windows, "
              f"4 profiles (ws {ws}, r {r}), cap {cap}, median of {ctx['runs']}: {'; '.join(line)}; all six outputs "
              f"equal the int64 host oracle's (host distances {host_ms / 1e3:.3f} s, candidates "
              f"{oracle_ms / 1e3:.3f} s) [{label}]")

    # K2 against its twin at the step's shape: a device's tiles' K codes
    tiles, _ = make_tiles(record, t, ws, 1)
    w = ws - 6 + 1
    kc = torch.nn.functional.pad(rolling_kmer_codes(torch.from_numpy(tiles).to(first), 6), (0, 1))
    ms, ab = kernel_ms(lambda: match_counts(kc, w, t), on_card, reps=5)
    plain_ms, ab_plain = kernel_ms(lambda: _match_counts_plain(kc, w, t), on_card, reps=1)
    err = max_err((ab, ab_plain))
    require(err == 0, "K2 at the two-axis step's shape differs from the plain twin")
    device_ms = queued_device_ms(lambda: match_counts(kc, w, t), reps=5) if on_card else None
    io = k2_io(tiles.shape[0], t, w)
    k2 = {"rows": tiles.shape[0], "t": t, "max_abs_err": err, "ms": float(ms), "ms_min": ms.min,
          "plain_ms": float(plain_ms), "device_ms": device_ms, "bound_ms": bound(*io)[0], "bound_by": bound(*io)[1]}
    print(f"K2 at the two-axis step's shape, {tiles.shape[0]} x {t + w} K codes: {ms:.4f} ms (fastest window "
          f"{ms.min:.4f}){'' if device_ms is None else f', device {device_ms:.4f} ms'}, plain twin {plain_ms:.3f} ms, "
          f"bound {k2['bound_ms']:.5f} ms ({k2['bound_by']}), bit-identical=True [{label}]")

    if not cards:  # the data axis's all-gather over a one-rank process group
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        initialize_distributed(f"localhost:{port}", num_processes=1, process_id=0, device=device)
        try:
            mesh = make_hybrid_mesh(n_clusters=2, devices=[first, first])
            require(mesh.distributed and mesh.shape == {"clusters": 2, "data": 1}, f"hybrid mesh {mesh.shape}")
            thrs = next(iter(cases.values()))
            got = sharded_cluster_scan_step(make_tiles(record, t, ws, 1)[0], profiles, thrs, k=6, ws=ws, r=r, cap=cap,
                                            mesh=mesh)
            want = two_axis_oracle([d[: got[0].shape[1]] for d in tile_dists], thrs, cap)
            require(all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(got, want)),
                    "two-axis step over a one-rank process group differs from the int64 host oracle")
            print(f"two-axis step on a (2 x 1) hybrid mesh over a one-rank process group ({dist.get_backend()}): "
                  f"the data axis's all-gather ran, outputs equal [{label}]")
        finally:
            dist.destroy_process_group()
    return {"launches": total, "k2": k2, "walls": walls}


def mesh_cards(device, label: str = "", contig_bp: int = 16_000_000, runs: int = 3) -> None:
    """The two-axis phase alone on a host with four cards (``python3
    chip_smoke.py --mesh-cards``): the step on one card and on the (2 x 2),
    (1 x 4) and (4 x 1) meshes over four cards, each equal to one card's
    outputs and the int64 host oracle's, each wall beside one card's."""
    import torch

    from kmergma_tpu_torch.utils.fasta import as_records

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        require(torch.cuda.device_count() >= 4, f"--mesh-cards needs four cards, {torch.cuda.device_count()} present")
        build_kernels(label)
    contigs = synthetic_genome(1, contig_bp, 500_000, [rec.codes for rec in as_records(REF)])
    out = two_axis_phase(dict(device=device, on_card=on_card, sync=torch.cuda.synchronize if on_card else (lambda: None),
                              label=label, runs=runs, contigs=contigs, launches=Launches(),
                              two_axis_tile=TWO_AXIS_TILE), cards=True)
    for case in dict.fromkeys(c for c, _ in out["walls"]):
        one = next(v for (c, what), v in out["walls"].items() if c == case and what.startswith("1 x 1"))
        print(f"two-axis step over four cards, thresholds {case}: " + "; ".join(
            f"{what} {v:.4f} s ({v / one:.2f}x one card's {one:.4f} s)"
            for (c, what), v in out["walls"].items() if c == case and not what.startswith("1 x 1")) + f" [{label}]")
    if on_card:
        engine_options_cards(contigs[0], [torch.device("cuda", i) for i in range(4)], label)


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


def planned_pass_walls(record, profile, clusters, cthrs, thr: float, device, on_card: bool, label: str,
                       n_frags: int = ORACLE_FRAGMENTS) -> dict:
    """The planned pass through engine calls an earlier checkout has too
    (R1's parent-against-change measure): one ``ScanEngine.record_stream``,
    ``ClusterScanEngine.record_streams`` and strobe ``StrobeSpanEngine
    .record_stream`` of ``record`` already on the card (``codes_dev``: the
    bitmap pass, the planned pass and its copy back), and ``n_frags``
    fragments of 16 kb cut from it through the cluster engine.  Wall ms a
    call, host clock between synchronises (median and fastest of five),
    and on the card device ms a call (torch.profiler, the sum of its
    device intervals over five calls; one for the fragments, whose 50,000
    intervals a call the profiler takes minutes to gather five times
    over).  {name: {ms, ms_min, device_ms}}."""
    import numpy as np
    import torch

    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes_torch

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    eng = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    prep = eng.prepare_codes(record)
    ceng = ClusterScanEngine(clusters.profiles, k=k, device=device)
    cprep = ceng.prepare_codes(record)
    sp = gen_strobe_ref_ws_cons(REF)
    sw, n_steps = sp.windowsize - sp.k, record.shape[0] - sp.windowsize - 1
    sc = strobe_2_mer_codes_torch(torch.from_numpy(record).to(device), sp.s, sp.w_min, sp.w_max, sp.q)
    seng = StrobeSpanEngine(sp, int(sc[sw]), device=device)
    sprep = seng.prepare_codes(sc[: n_steps + sw])
    n_frags = min(n_frags, record.shape[0] // FRAGMENT_BP)
    frags = np.ascontiguousarray(record[: n_frags * FRAGMENT_BP].reshape(n_frags, FRAGMENT_BP))
    calls = {
        "planned_single": lambda: eng.record_stream(record, thr, codes_dev=prep),
        "planned_cluster": lambda: ceng.record_streams(record, cthrs, codes_dev=cprep),
        "planned_strobe": lambda: seng.record_stream(sc[: n_steps + sw], 30.0, codes_dev=sprep),
        "planned_fragments": lambda: [ceng.record_streams(f, cthrs) for f in frags],
    }
    out = {}
    for name, call in calls.items():
        call()
        times = [clock(call, sync)[0] for _ in range(5)]
        reps = 1 if name == "planned_fragments" else 5
        row = {"ms": statistics.median(times), "ms_min": min(times),
               "device_ms": device_ms_per_call(call, reps=reps)[0] if on_card else None}
        out[name] = row
        dev = "" if row["device_ms"] is None else f", device {row['device_ms']:.4f} ms"
        print(f"{name}: {row['ms']:.3f} ms a call (fastest {row['ms_min']:.3f}){dev} [{label}]")
    frag_bp = n_frags * FRAGMENT_BP
    out["planned_fragments"]["mbps"] = frag_bp / out["planned_fragments"]["ms"] / 1e3
    return out


def r1_alone(record, profile, clusters, cthrs, thr: float, device, on_card: bool, label: str, many=()) -> dict:
    """R1 alone on the inputs of one planned pass each (R1's
    parent-against-change measure, through calls an earlier checkout has
    too): ``ScanEngine.record_stream`` of ``record`` (m = 1),
    ``ClusterScanEngine.record_streams`` of it (m = 6) and of its first 16
    kb (a fragment), and of it on K3 with each m of ``many`` clusters
    (``many_cluster_sets``).  Wrapper ms back to back (``kernel_ms``) and,
    on the card, device ms queued behind a spin and summed by
    torch.profiler.  {name: {ms, ms_min, device_ms, device_profiled_ms}}."""
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.scan_kernels import run_reduce_multi
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_thresholds

    k, ws, r = profile.k, profile.windowsize, profile.n_records
    eng = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    ceng = ClusterScanEngine(clusters.profiles, k=k, device=device)
    calls = {
        "R1_single_m1": lambda: eng.record_stream(record, thr),
        "R1_cluster_m6": lambda: ceng.record_streams(record, cthrs),
        "R1_fragment_m6": lambda: ceng.record_streams(record[:FRAGMENT_BP], cthrs),
    }
    for m in many:
        _cut, mc = many_cluster_sets(m)
        meng = ClusterScanEngine(mc.profiles, k=k, device=device)
        meng.fused_min_windows = 1
        mthrs = estimate_optimal_thresholds(mc.kfvs, mc.windowsizes, buffer=7.0)
        calls[f"R1_many_m{m}"] = lambda meng=meng, mthrs=mthrs: meng.record_streams(record, mthrs)
    out = {}
    for name, call in calls.items():
        cap = R1Capture()
        cap.once(call)()
        args = cap.args
        ms, _ = kernel_ms(lambda: run_reduce_multi(*args), on_card)
        out[name] = {"ms": float(ms), "ms_min": ms.min, "device_ms": None, "device_profiled_ms": None,
                     "profiles": len(args[0]), "rows": sum(d.shape[0] for d in args[0])}
        dev = ""
        if on_card:
            out[name]["device_ms"] = queued_device_ms(lambda: run_reduce_multi(*args), reps=r1_queued_reps(len(args[0])))
            out[name]["device_profiled_ms"], _ = device_ms_per_call(lambda: run_reduce_multi(*args))
            dev = f", device {out[name]['device_ms']:.5f} ms queued, {out[name]['device_profiled_ms']:.5f} profiled"
        print(f"{name}: R1 alone on {out[name]['profiles']} profiles, {out[name]['rows']} region rows: "
              f"{ms:.4f} ms a wrapper call (fastest window {ms.min:.4f}){dev} [{label}]")
    return out


def r1_kernels(device, label: str = "", contig_bp: int = 16_000_000, many=(35, 84)) -> dict:
    """R1 alone (``python3 chip_smoke.py --r1-alone``): the kernel build
    with ptxas's lines, then ``r1_alone`` on the first contig of the
    synthetic genome at m = 1, 6, a fragment's 6 and each m of ``many``.
    A copy of the checkout with another build of R1 is timed by running
    this from its root."""
    import torch

    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_threshold, estimate_optimal_thresholds
    from kmergma_tpu_torch.utils.fasta import as_records

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        build_kernels(label)
    profile = gen_ref_ws_cons(REF, 6)
    record = synthetic_genome(1, contig_bp, 500_000, [rec.codes for rec in as_records(REF)])[0]
    clusters = eliminate_null_params(cluster_ref_api(REF, 6))
    cthrs = estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0)
    thr = estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0)
    return r1_alone(record, profile, clusters, cthrs, thr, device, on_card, label, many=many)


def pair_kernels(device, label: str = "", contig_bp: int = 16_000_000, whole_bp: int = 4_000_000) -> dict:
    """K2, K4, K6 and K5 alone at the shapes the main paths give them
    (``python3 chip_smoke.py --pair-kernels``): the first contig of the
    synthetic genome, K1's bitmap over it for K2's region rows, the
    whole-record scan's rows, the mixed-depth split pass's K4 and K6
    shapes, and the cluster split pass's K5 on its first 60 kb, 16 kb and
    ``whole_bp``, each against its plain twin; then the planned pass's
    engine calls (``planned_pass_walls``), and R1 alone on the inputs of a
    planned pass at m = 1 and 6 (``r1_alone``): R1's measure.  It calls only
    the package's public wrappers and engines, so the same script times an
    earlier checkout of the package: run from a copy of this file placed
    in that checkout's root.  Returns {shape: {ms, ms_min, device_ms}}."""
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
    contigs = synthetic_genome(4, contig_bp, 500_000, [rec.codes for rec in as_records(REF)])
    record = contigs[0]
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    thr = estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0)
    nw = record.shape[0] - ws + 1
    prep = engine.prepare_codes(record)
    depth = engine.bound_depth
    l0 = _first_window_l0(prep, engine.s_dev, k=k, ws=ws, r=r, depth=depth)
    bm = fused_record_bitmaps(prep, engine.s_dev, thr=int(engine._thr_int(thr)), l0=l0, nw=nw, k=k, ws=ws, r=r, depth=depth,
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
    out.update(planned_pass_walls(record, profile, clusters, cthrs, thr, device, on_card, label))
    out.update(r1_alone(record, profile, clusters, cthrs, thr, device, on_card, label))
    return out


def run(device, contig_bp: int = 16_000_000, n_contigs: int = 4, plant_every: int = 500_000, whole_bp: int = 4_000_000, runs: int = 3, label: str = "", bench_sizes: dict | None = None, fragments: int = FRAGMENTS, long_bp: int = LONG_BP, long_chunk: int | None = None, max_k: int = MAX_K, two_axis_tile: int = TWO_AXIS_TILE) -> dict:
    """All phases on ``device``; raises SmokeFailure on any failed check.
    ``runs`` timed runs follow one warm-up in the TP and two-axis
    phases; ``bench_sizes`` are the bench
    phase's row sizes (``BENCH_SIZES`` by default), ``fragments`` the
    fragmented assembly's record count; ``long_bp`` the long record's
    length and ``long_chunk`` its engine's ``chunk_windows`` (the default
    when None); ``max_k`` the k of ScanEngine's largest table (``MAX_K``);
    ``two_axis_tile`` the two-axis step's tile (``TWO_AXIS_TILE``).
    Returns the kernels' report."""
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
        launches=Launches(), r1_inputs={}, r1_launches={}, r1_kernel_launches={}, bench_sizes=BENCH_SIZES if bench_sizes is None else bench_sizes, fragments=fragments,
        long_bp=long_bp, long_chunk=long_chunk, plant_every=plant_every, max_k=max_k, two_axis_tile=two_axis_tile,
    )
    with tempfile.TemporaryDirectory() as tmp:
        ctx.update(tmp=Path(tmp), fasta=Path(tmp) / "genome.fasta", cluster_fasta=Path(tmp) / "cluster_genome.fasta",
                   uninterrupted={})
        write_fasta(ctx["fasta"], contigs)
        kernels = single_profile_phase(ctx) + cluster_phase(ctx)
        many_clusters_phase(ctx)
        kernels += strobe_phase(ctx) + [r1_phase(ctx)]
        a1 = aligner_phase(ctx)
        checkpoint_phase(ctx)
        long_launches = long_record_phase(ctx)
        tp_phase(ctx)
        two_axis = two_axis_phase(ctx)
    paired_spectrum_check(ctx)
    kernels += mixed_depth_phase(ctx)
    options = engine_options_phase(ctx)
    kernels += bench_phase(ctx) + [a1]
    for row in kernels:  # each kernel's launches on the long-record and sharded path, the two-axis step's, the options'
        row["long_path_launches"] = long_launches[row["name"].split("[")[0]]
        row["two_axis_launches"] = two_axis["launches"][row["name"].split("[")[0]]
        row["options_launches"] = options["launches"][row["name"].split("[")[0]]
        if row["name"] in options["shapes"]:
            row["depth_shapes"] = options["shapes"][row["name"]]
        if row["name"] == "match_counts":
            row["two_axis"] = two_axis["k2"]
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
        if sys.argv[1:] == ["--r1-alone"]:
            print(json.dumps({"r1_alone": r1_kernels("cuda", label=label)}))
            print(f"card: {label}")
            return 0
        if sys.argv[1:] == ["--tp-cards"]:
            tp_cards("cuda", label=label)
            print(f"card: {label}")
            return 0
        if sys.argv[1:] == ["--mesh-cards"]:
            mesh_cards("cuda", label=label)
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
