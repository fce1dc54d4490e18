"""Single-profile genome miner on the PyTorch scan (counterpart of
``kmergma_tpu.models.miner``).

Per contig (records shorter than the windowsize are skipped):
  1. device: the planned scan (ops/scan.ScanEngine) emits the sparse
     candidate stream,
  2. host: exact replay of the minima state machine (``replay_single``),
  3. host: optional semi-global alignment trim of every hit of the record
     in one native batch (``semiglobal_align_batch``),
  4. hit records formatted exactly like the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.align import AlignResult, cigar_to_unitrange, semiglobal_align, semiglobal_align_batch
from ..ops.reference import RefProfile
from ..ops.scan import ScanEngine
from ..ops.scan_host import HostScanEngine
from ..utils.checkpoint import ScanCheckpoint
from ..utils.fasta import FastaRecord, PathOrRecords, as_records
from .state_machine import replay_single


def fmt_dist(x: float) -> str:
    """Julia's string(round(x, digits=2)): IEEE round-half-even to 2
    decimals, shortest-repr formatting."""
    return repr(round(float(x), 2))


@dataclass
class ScanStats:
    """Counters of a mine run."""

    records_scanned: int = 0
    records_skipped: int = 0
    bp_scanned: int = 0
    windows_scanned: int = 0
    candidate_windows: int = 0
    hits: int = 0
    wall_seconds: float = 0.0

    @property
    def mbp_per_second(self) -> float:
        return self.bp_scanned / self.wall_seconds / 1e6 if self.wall_seconds else 0.0


@dataclass
class MineResult:
    hits: list[FastaRecord] = field(default_factory=list)
    hit_loci: list[int] = field(default_factory=list)
    alignments: list[AlignResult] = field(default_factory=list)
    dists: np.ndarray | None = None  # concatenated per-window distances
    stats: ScanStats | None = None


def _default_engine(profile: RefProfile, device: "str | torch.device" = "cuda"):
    """The device engine on ``device``, or the exact int64 host engine
    where the scaled distances would overflow int32."""
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    try:
        return ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=device)
    except OverflowError:
        return HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r)


def record_kmergma(
    record: FastaRecord,
    profile: RefProfile,
    thr: float = 30,
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -69,
    gap_extend: int = -1,
    engine: "ScanEngine | HostScanEngine | None" = None,
    device: "str | torch.device" = "cuda",
) -> list[FastaRecord]:
    """Single-record scan with the MultiThread miner's output format: the
    standard miner's hit set, with no ``GenomePos`` field in the
    description.  Without ``engine``, the device engine runs on ``device``
    (the card unless the caller asks for the CPU)."""
    k, ws = profile.k, profile.windowsize
    seq_len = len(record)
    if engine is None:
        engine = _default_engine(profile, device)
    if seq_len < ws:
        return []
    dist0, stream, _ = engine.record_stream(record.codes, thr)
    hits: list[FastaRecord] = []
    for hit in replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=seq_len, buff=buff):
        start, stop = hit.start, hit.stop
        if do_align:
            window = record.seq[start - 1 : stop].decode("ascii").upper()
            aln = semiglobal_align(profile.consensus_ws, window, gap_open, gap_extend)
            lo, hi = cigar_to_unitrange(aln)
            start, stop = max(1, hit.start + lo - 1), min(hit.start + hi - 1, seq_len)
        desc = (
            f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
            f" | MatchPos = {start}:{stop}"
            f" | Len = {stop - start + 1}"
        )
        hits.append(FastaRecord(desc, record.seq[start - 1 : stop].upper()))
    return hits


def mine_genome(
    genome: PathOrRecords,
    profile: RefProfile,
    thr: float,
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -69,
    gap_extend: int = -1,
    do_return_dists: bool = False,
    do_return_align: bool = False,
    get_hit_loci: bool = False,
    engine: "ScanEngine | HostScanEngine | None" = None,
    checkpoint_path: str | None = None,
    device: "str | torch.device" = "cuda",
) -> MineResult:
    """Mine a genome against one profile.  Without ``engine``, the device
    engine runs on ``device`` (the card unless the caller asks for the
    CPU), or the int64 host engine where int32 would overflow.

    With ``checkpoint_path`` the run records its progress after each record
    (utils/checkpoint.py) and, started again on the same file, resumes from
    the first record it had not finished, with the hits and loci of the
    records before it; the file is removed when the run completes.  The
    checkpoint is the JAX package's, identity string included, so either
    package resumes the other's.  ``dists`` and ``stats`` cover only the
    records this call scanned."""
    k, ws = profile.k, profile.windowsize
    if engine is None:
        engine = _default_engine(profile, device)
    consensus_ws = profile.consensus_ws
    res = MineResult()
    res.stats = stats = ScanStats()
    dist_parts: list[np.ndarray] = []
    t_start = time.perf_counter()

    ckpt = None
    if checkpoint_path is not None:
        genome_id = f"{genome if isinstance(genome, str) else 'records'}|k={k}|ws={ws}|thr={thr}"
        ckpt = ScanCheckpoint.load_or_create(checkpoint_path, genome_id)
        res.hits.extend(ckpt.restore_hits())
        res.hit_loci.extend(ckpt.hit_loci)

    genome_pos = ckpt.genome_pos if ckpt else 0
    for record_idx, record in enumerate(as_records(genome)):
        if ckpt and record_idx < ckpt.next_record:
            continue
        hits_before, loci_before = len(res.hits), len(res.hit_loci)
        seq_len = len(record)
        if seq_len < ws:
            # the reference's `continue` also skips genome_pos
            stats.records_skipped += 1
            if ckpt:
                ckpt.record_done(record_idx, genome_pos, [], [])
            continue
        dist0, stream, dists = engine.record_stream(record.codes, thr, collect_dists=do_return_dists)
        stats.records_scanned += 1
        stats.bp_scanned += seq_len
        stats.windows_scanned += seq_len - ws + 1
        stats.candidate_windows += len(stream)
        if dists is not None:
            dist_parts.append(dists[1:])  # the reference records only the iterative phase

        raw_hits = replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=seq_len, buff=buff)
        alns = None
        if do_align and raw_hits:
            windows = [
                record.seq[h.start - 1 : h.stop].decode("ascii").upper()
                for h in raw_hits
            ]
            alns = semiglobal_align_batch(consensus_ws, windows, gap_open, gap_extend)
        for hit_i, hit in enumerate(raw_hits):
            start, stop = hit.start, hit.stop
            if do_align:
                # the CIGAR range counts query-only (I) ops too, so the
                # trimmed range can extend beyond the window, clamped only
                # at the contig end
                aln = alns[hit_i]
                if do_return_align:
                    res.alignments.append(aln)
                lo, hi = cigar_to_unitrange(aln)
                start, stop = max(1, hit.start + lo - 1), min(hit.start + hi - 1, seq_len)
            desc = (
                f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
                f" | MatchPos = {start}:{stop}"
                f" | GenomePos = {genome_pos}"
                f" | Len = {stop - start + 1}"
            )
            res.hits.append(FastaRecord(desc, record.seq[start - 1 : stop].upper()))
            if get_hit_loci:
                res.hit_loci.append(start + genome_pos)
        genome_pos += seq_len
        if ckpt:
            ckpt.record_done(record_idx, genome_pos, res.hits[hits_before:], res.hit_loci[loci_before:])

    if ckpt:
        ckpt.done()
    stats.hits = len(res.hits)
    stats.wall_seconds = time.perf_counter() - t_start
    if do_return_dists:
        res.dists = np.concatenate(dist_parts) if dist_parts else np.empty(0)
    return res
