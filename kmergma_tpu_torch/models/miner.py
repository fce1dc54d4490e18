"""Single-profile genome miner on the PyTorch scan (counterpart of
``kmergma_tpu.models.miner``).

Per contig (records shorter than the windowsize are skipped):
  1. device: the planned scan (ops/scan.ScanEngine) emits the sparse
     candidate stream; the next eligible record's copy to the device is
     queued first (cross-record prefetch), and a long record resumes
     from its last finished segment when a checkpoint holds one,
  2. host: exact replay of the minima state machine (``replay_single``),
  3. optional semi-global alignment trim of every hit of the record in
     one batch (``align_hits_batch``: the native host DP, or the device
     aligner under ``KMERGMA_ALIGN_DEVICE=1``),
  4. hit records formatted exactly like the reference.
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

    records = as_records(genome)

    # cross-record prefetch: the next eligible record's copy to the device
    # is queued before the current record is scanned, so it overlaps the
    # scan; records long enough to be segmented manage their own copies,
    # and engines that copy per shard (sharded) opt out
    prefetched: dict[int, object] = {}

    def _prefetch_after(idx: int) -> None:
        if not getattr(engine, "prefetch_h2d", False):
            return
        for j in range(idx + 1, len(records)):
            if ckpt and j < ckpt.next_record:
                continue
            n_j = len(records[j])
            if n_j >= ws and (n_j - ws + 1) <= 2 * engine.chunk:
                if j not in prefetched:
                    prefetched[j] = engine.prepare_codes(records[j].codes)
                return

    genome_pos = ckpt.genome_pos if ckpt else 0
    for record_idx, record in enumerate(records):
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
        with trace.span("record") as sp:
            codes_dev = prefetched.pop(record_idx, None)
            _prefetch_after(record_idx)
            dist0, stream, dists = engine.record_stream(
                record.codes, thr, collect_dists=do_return_dists, codes_dev=codes_dev,
                seg_tracker=ckpt.segment_tracker(record_idx) if ckpt else None,
            )
            stats.records_scanned += 1
            stats.bp_scanned += seq_len
            stats.windows_scanned += seq_len - ws + 1
            stats.candidate_windows += len(stream)
            sp.add(bp=seq_len, windows=seq_len - ws + 1, candidates=len(stream))
            if dists is not None:
                dist_parts.append(dists[1:])  # the reference records only the iterative phase

            with trace.span("replay") as sp_replay:
                raw_hits = replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=seq_len, buff=buff)
                sp_replay.add(hits=len(raw_hits))
            stats.replay_hits += len(raw_hits)
            alns = None
            if do_align and raw_hits:
                windows = [
                    seq_slice(record, h.start - 1, h.stop).decode("ascii").upper()
                    for h in raw_hits
                ]
                stats.windows_aligned += len(windows)
                alns = align_hits_batch(consensus_ws, windows, gap_open, gap_extend, device=device)
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
                res.hits.append(FastaRecord(desc, seq_slice(record, start - 1, stop).upper()))
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
