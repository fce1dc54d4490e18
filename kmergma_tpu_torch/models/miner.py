"""Single-profile genome miner on the PyTorch scan (counterpart of
``kmergma_tpu.models.miner``).

Per contig (records shorter than the windowsize are skipped):
  1. device: the planned scan (ops/scan.ScanEngine) emits the sparse
     candidate stream; the next record's copy to the device is queued
     first where the engine takes it whole (cross-record prefetch), and a
     long record resumes from its last finished segment when a checkpoint
     holds one,
  2. host: exact replay of the minima state machine (``replay_single``),
  3. optional semi-global alignment trim of every hit of the record in
     one batch (``align_hits_batch``: the device aligner A1 for 16 hits
     or more on a card, else the native host DP),
  4. hit records formatted exactly like the reference.

The record loop (``mine_records``: checkpoint, short records,
``GenomePos``, the ``record`` span and its counters, the prefetch) and
the batched trim and format of hits (``add_hits``) are shared with the
cluster and strobemer miners.
"""

from __future__ import annotations

import time
from dataclasses import KW_ONLY, dataclass, field

import numpy as np
import torch

from ..ops.align import AlignResult, align_hits_batch, cigar_to_unitrange, semiglobal_align
from ..ops.reference import RefProfile
from ..ops.scan import ScanEngine
from ..ops.scan_host import HostScanEngine
from ..parallel.mesh import joined, make_mesh
from ..parallel.tp_lookup import TPScanEngine
from ..utils import trace
from ..utils.checkpoint import ScanCheckpoint
from ..utils.fasta import FastaRecord, PathOrRecords, as_records, seq_slice
from .state_machine import replay_single


def fmt_dist(x: float) -> str:
    """Julia's string(round(x, digits=2)): IEEE round-half-even to 2
    decimals, shortest-repr formatting."""
    return repr(round(float(x), 2))


@dataclass
class ScanStats:
    """Counters of a mine run (the ``call`` span's, when tracing:
    utils/trace.py).  ``replay_hits`` counts the hits the replay emitted
    (in cluster mode the candidates it handed to the overlap checks),
    ``windows_aligned`` the windows sent to the aligner."""

    records_scanned: int = 0
    records_skipped: int = 0
    bp_scanned: int = 0
    windows_scanned: int = 0
    candidate_windows: int = 0
    hits: int = 0
    wall_seconds: float = 0.0
    _: KW_ONLY
    replay_hits: int = 0
    windows_aligned: int = 0

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


#: profiles with more bins than this shard their table over the devices
#: of a mesh when there is more than one (``TPScanEngine``), as the JAX
#: miner routes them
TP_MIN_BINS = 2**18


def _tp_mesh(k: int, device: "str | torch.device"):
    """The mesh a big-k profile shards over, or None.  For 4^k >
    ``TP_MIN_BINS``: over the processes when this one joined a group of
    more than one rank through ``initialize_distributed``; else over every
    visible card, the current one first, when ``device`` is ``"cuda"``
    with no index and more than one card is present.  A caller that names
    one card (``"cuda:1"``) scans on that card alone."""
    import torch.distributed as dist

    if 4**k <= TP_MIN_BINS:
        return None
    if joined() and dist.get_world_size() > 1:
        return make_mesh(device=device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        n, first = torch.cuda.device_count(), torch.cuda.current_device()
        return make_mesh(devices=[torch.device("cuda", (first + i) % n) for i in range(n)])
    return None


def _default_engine(profile: RefProfile, device: "str | torch.device" = "cuda"):
    """The engine the miners build: the profile-sharded ``TPScanEngine``
    for a big-k profile where several devices are present (``_tp_mesh``),
    else the device engine on ``device``; the exact int64 host engine
    where the scaled distances would overflow int32."""
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    try:
        mesh = _tp_mesh(k, device)
        if mesh is not None:
            return TPScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=mesh)
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
    *,
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
            window = seq_slice(record, start - 1, stop).decode("ascii").upper()
            aln = semiglobal_align(profile.consensus_ws, window, gap_open, gap_extend)
            lo, hi = cigar_to_unitrange(aln)
            start, stop = max(1, hit.start + lo - 1), min(hit.start + hi - 1, seq_len)
        desc = (
            f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
            f" | MatchPos = {start}:{stop}"
            f" | Len = {stop - start + 1}"
        )
        hits.append(FastaRecord(desc, seq_slice(record, start - 1, stop).upper()))
    return hits


@dataclass
class RecordScan:
    """One record of a mine run, as ``mine_records`` hands it to the
    miner: its index in the genome, the record, its ``GenomePos``, its
    codes already on the engine's device where they were copied while the
    record before it was scanned (else None), its checkpoint's segment
    tracker (else None), and its ``record`` span."""

    idx: int
    record: FastaRecord
    genome_pos: int
    codes_dev: object
    seg_tracker: object
    span: object
    stats: ScanStats

    def scanned(self, windows: int, candidates: int) -> None:
        """Count the record's scan: the windows it scanned (every
        cluster's, in cluster mode) and its candidate stream entries."""
        n = len(self.record)
        st = self.stats
        st.records_scanned += 1
        st.bp_scanned += n
        st.windows_scanned += windows
        st.candidate_windows += candidates
        self.span.add(bp=n, windows=windows, candidates=candidates)


def genome_name(genome: PathOrRecords) -> str:
    """The genome's part of a checkpoint's identity string."""
    return genome if isinstance(genome, str) else "records"


def mine_records(res: MineResult, parse, genome_id: str, checkpoint_path: str | None, scan, *,
                 min_len: int, skip_advances: bool = False, engine=None) -> None:
    """The record loop of the three miners.  ``parse()`` gives the records
    (the miner's own ``as_records`` call); ``scan(rec)`` does the miner's
    work on one record (a ``RecordScan``) inside its ``record`` span: it
    scans, counts the scan (``rec.scanned``), replays and adds the
    record's hits and loci to ``res``.

    With ``checkpoint_path`` the run opens the checkpoint of identity
    ``genome_id`` and restores its hits and loci, skips the records it has
    done, records each record as done and removes the file at the end.  A
    record shorter than ``min_len`` is skipped; it advances ``GenomePos``
    only with ``skip_advances`` (cluster mode; the single and strobemer
    miners keep the reference's ``continue``, which skips it too).  Where
    ``engine.takes_whole`` says the engine takes the next record to be
    scanned whole, that record's copy to the device is queued before the
    current one is scanned, so the two overlap.  Sets ``res.stats``, its
    ``hits`` and its ``wall_seconds``, which cover the parse."""
    t_start = time.perf_counter()
    res.stats = stats = ScanStats()
    ckpt = None
    if checkpoint_path is not None:
        ckpt = ScanCheckpoint.load_or_create(checkpoint_path, genome_id)
        res.hits.extend(ckpt.restore_hits())
        res.hit_loci.extend(ckpt.hit_loci)
    records = parse()
    takes_whole = getattr(engine, "takes_whole", None)
    genome_pos = ckpt.genome_pos if ckpt else 0
    ahead = None  # the next record to scan, on the device, where copied ahead
    for idx in range(ckpt.next_record if ckpt else 0, len(records)):
        record = records[idx]
        hits_before, loci_before = len(res.hits), len(res.hit_loci)
        if len(record) < min_len:
            stats.records_skipped += 1
            if skip_advances:
                genome_pos += len(record)
            if ckpt:
                ckpt.record_done(idx, genome_pos, [], [])
            continue
        with trace.span("record") as sp:
            codes_dev, ahead = ahead, None
            nxt = next((j for j in range(idx + 1, len(records)) if len(records[j]) >= min_len), None)
            if takes_whole is not None and nxt is not None and takes_whole(len(records[nxt])):
                ahead = engine.prepare_codes(records[nxt].codes)
            scan(RecordScan(idx, record, genome_pos, codes_dev, ckpt.segment_tracker(idx) if ckpt else None, sp, stats))
        genome_pos += len(record)
        if ckpt:
            ckpt.record_done(idx, genome_pos, res.hits[hits_before:], res.hit_loci[loci_before:])
    if ckpt:
        ckpt.done()
    stats.hits = len(res.hits)
    stats.wall_seconds = time.perf_counter() - t_start


def hit_windows(record: FastaRecord, raw_hits) -> list[str]:
    """Each hit's window of ``record``, upper-case, as the aligner takes it."""
    return [seq_slice(record, h.start - 1, h.stop).decode("ascii").upper() for h in raw_hits]


def add_hits(res: MineResult, rec: RecordScan, raw_hits, alns, *, keep_align: bool, keep_loci: bool,
             min_score: int | None = None) -> int:
    """Add a record's hits to ``res`` in the reference's format, each
    trimmed to its alignment where ``alns`` (one a hit) is given, with its
    alignment (``keep_align``) and locus (``keep_loci``).  With
    ``min_score``, a hit whose alignment scores below it is dropped
    (StrobeGMA's filter, Alignment.jl:96-98).  Returns the hits dropped."""
    record, genome_pos, seq_len = rec.record, rec.genome_pos, len(rec.record)
    dropped = 0
    for hit_i, hit in enumerate(raw_hits):
        start, stop = hit.start, hit.stop
        if alns is not None:
            aln = alns[hit_i]
            if min_score is not None and aln.score < min_score:
                dropped += 1
                continue
            if keep_align:
                res.alignments.append(aln)
            # the CIGAR range counts query-only (I) ops too, so the trimmed
            # range can extend beyond the window, clamped only at the
            # contig end
            lo, hi = cigar_to_unitrange(aln)
            start, stop = max(1, hit.start + lo - 1), min(hit.start + hi - 1, seq_len)
        desc = (
            f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
            f" | MatchPos = {start}:{stop}"
            f" | GenomePos = {genome_pos}"
            f" | Len = {stop - start + 1}"
        )
        res.hits.append(FastaRecord(desc, seq_slice(record, start - 1, stop).upper()))
        if keep_loci:
            res.hit_loci.append(start + genome_pos)
    return dropped


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
    *,
    device: "str | torch.device" = "cuda",
) -> MineResult:
    """Mine a genome against one profile.  Without ``engine``, the device
    engine runs on ``device`` (the card unless the caller asks for the
    CPU), or the int64 host engine where int32 would overflow.

    With ``checkpoint_path`` the run records its progress after each record
    (utils/checkpoint.py) and, started again on the same file, resumes from
    the first record it had not finished, with the hits and loci of the
    records before it; the file is removed when the run completes.  A
    segmented record (longer than 2 x ``engine.chunk`` windows) also
    records each finished segment, and resumes after the last one.  The
    checkpoint is the JAX package's, identity string included, so either
    package resumes the other's.  ``dists`` and ``stats`` cover only the
    records this call scanned."""
    k, ws = profile.k, profile.windowsize
    if engine is None:
        engine = _default_engine(profile, device)
    res = MineResult()
    dist_parts: list[np.ndarray] = []

    def scan(rec: RecordScan) -> None:
        record, seq_len = rec.record, len(rec.record)
        dist0, stream, dists = engine.record_stream(
            record.codes, thr, collect_dists=do_return_dists, codes_dev=rec.codes_dev, seg_tracker=rec.seg_tracker,
        )
        rec.scanned(seq_len - ws + 1, len(stream))
        if dists is not None:
            dist_parts.append(dists[1:])  # the reference records only the iterative phase
        with trace.span("replay") as sp_replay:
            raw_hits = replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=seq_len, buff=buff)
            sp_replay.add(hits=len(raw_hits))
        res.stats.replay_hits += len(raw_hits)
        alns = None
        if do_align and raw_hits:
            windows = hit_windows(record, raw_hits)
            res.stats.windows_aligned += len(windows)
            alns = align_hits_batch(profile.consensus_ws, windows, gap_open, gap_extend, device=device)
        add_hits(res, rec, raw_hits, alns, keep_align=do_return_align, keep_loci=get_hit_loci)

    # the reference's `continue` on a record shorter than ws also skips genome_pos
    mine_records(res, lambda: as_records(genome), f"{genome_name(genome)}|k={k}|ws={ws}|thr={thr}", checkpoint_path,
                 scan, min_len=ws, engine=engine)
    if do_return_dists:
        res.dists = np.concatenate(dist_parts) if dist_parts else np.empty(0)
    return res
