"""Cluster-mode (multi-profile) genome miner on the PyTorch scan
(counterpart of ``kmergma_tpu.models.omn_miner``).

Per contig (records too short for the widest cluster are skipped):
  1. device: one cluster pass (ops/scan_cluster.ClusterScanEngine) emits
     the m per-cluster candidate streams,
  2. host: exact replay of the cluster minima state machine
     (``replay_omn``), streams merged in (window, cluster) order, with the
     reference's two overlap checks (KmerGMA.jl OmnGenomeMiner.jl:126 and
     :139) and its quirk that a rejected hit does not reset its cluster's
     running minimum,
  3. host: the alignment trim of each candidate against its cluster's
     consensus, one at a time, since acceptance decides what the next
     candidate is checked against; each goes through the native DP of
     ``semiglobal_align_batch`` (bit-identical to ``semiglobal_align``,
     whose NumPy DP the JAX miner calls),
  4. hit records formatted exactly like the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.align import cigar_to_unitrange, semiglobal_align_batch
from ..ops.reference import RefProfile
from ..ops.scan_cluster import ClusterScanEngine
from ..utils.checkpoint import ScanCheckpoint
from ..utils.fasta import FastaRecord, PathOrRecords, as_records
from .miner import MineResult, ScanStats, fmt_dist
from .state_machine import OmnHitEvent, replay_omn


def mine_genome_clusters(
    genome: PathOrRecords,
    profiles: list[RefProfile],
    thr_vec: list[float],
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -200,
    gap_extend: int = -1,
    do_return_dists: bool = False,
    do_return_align: bool = False,
    get_hit_loci: bool = False,
    engine: "ClusterScanEngine | None" = None,
    checkpoint_path: str | None = None,
    device: "str | torch.device" = "cuda",
) -> MineResult:
    """``engine`` may be any object with the cluster engine's
    ``record_streams(codes, thrs)`` and per-cluster ``engines[c].
    record_stream(codes, thr, collect_dists=True)``, such as an exact int64
    host oracle; by default the device ``ClusterScanEngine`` on ``device``
    (the card unless the caller asks for the CPU).  ``checkpoint_path``
    checkpoints and resumes per record, as ``mine_genome``'s does; a
    record too short to scan advances ``GenomePos`` before it is recorded
    as done, as the JAX miner's does."""
    m = len(profiles)
    if len(thr_vec) != m:
        raise ValueError(f"{m} cluster profiles but {len(thr_vec)} thresholds")
    k = profiles[0].k
    windowsizes = [p.windowsize for p in profiles]
    maxws = max(windowsizes)
    cluster_engine = engine if engine is not None else ClusterScanEngine(profiles, k=k, device=device)

    res = MineResult()
    res.stats = stats = ScanStats()
    t_start = time.perf_counter()
    dist_parts: list[list[np.ndarray]] = [[] for _ in range(m)]

    # cluster-mode state (prev_range, per-cluster minima) resets per
    # record, so resuming from the next unfinished record is exact
    ckpt = None
    if checkpoint_path is not None:
        genome_id = (
            f"{genome if isinstance(genome, str) else 'records'}|cluster"
            f"|k={k}|ws={windowsizes}|thr={list(thr_vec)}"
        )
        ckpt = ScanCheckpoint.load_or_create(checkpoint_path, genome_id)
        res.hits.extend(ckpt.restore_hits())
        res.hit_loci.extend(ckpt.hit_loci)

    genome_pos = ckpt.genome_pos if ckpt else 0
    for record_idx, record in enumerate(as_records(genome)):
        if ckpt and record_idx < ckpt.next_record:
            continue
        hits_before, loci_before = len(res.hits), len(res.hit_loci)
        seq_len = len(record)
        imax = seq_len - maxws - k + 2
        if imax < 1:
            stats.records_skipped += 1
            genome_pos += seq_len
            if ckpt:
                ckpt.record_done(record_idx, genome_pos, [], [])
            continue
        stats.records_scanned += 1
        stats.bp_scanned += seq_len
        stats.windows_scanned += m * imax

        if do_return_dists:
            # every window of every cluster, through each cluster's
            # whole-record distance scan
            dist0s, streams = [], []
            for ind in range(m):
                d0, stream, dists = cluster_engine.engines[ind].record_stream(
                    record.codes, thr_vec[ind], collect_dists=True,
                )
                dist0s.append(d0)
                streams.append(stream)
                dist_parts[ind].append(dists[1 : imax + 1])
        else:
            pairs = cluster_engine.record_streams(record.codes, thr_vec)
            dist0s = [p[0] for p in pairs]
            streams = [p[1] for p in pairs]
        stats.candidate_windows += sum(len(s) for s in streams)

        prev_range = (0, 0)  # 1-based inclusive; (0, 0) matches Julia's 0:0

        def process(ev: OmnHitEvent) -> bool:
            nonlocal prev_range
            cmi = ev.cmi
            if prev_range[0] <= cmi <= prev_range[1]:
                return False
            ws_i = windowsizes[ev.cluster]
            rng = (max(cmi - buff, 1), min(cmi + ws_i - 1 + buff, seq_len))
            if do_align:
                # against the stored cluster consensus as it is (truncated
                # to ws for real clusters, full length for the appended
                # average cluster; OmnGenomeMiner.jl:131)
                lo, hi = rng
                window = record.seq[lo - 1 : hi].decode("ascii").upper()
                aln = semiglobal_align_batch(profiles[ev.cluster].consensus, [window], gap_open, gap_extend)[0]
                if do_return_align:
                    # collected before the second overlap check
                    # (OmnGenomeMiner.jl:132)
                    res.alignments.append(aln)
                alo, ahi = cigar_to_unitrange(aln)
                rng = (max(1, lo + alo - 1), min(lo + ahi - 1, seq_len))
            if not (rng[1] < prev_range[0] or rng[0] > prev_range[1]):
                return False
            desc = (
                f"{record.identifier} | Dist = {fmt_dist(ev.dist)}"
                f" | KFV = {ev.cluster + 1}"
                f" | MatchPos = {rng[0]}:{rng[1]}"
                f" | GenomePos = {genome_pos}"
                f" | Len = {rng[1] - rng[0] + 1}"
            )
            res.hits.append(FastaRecord(desc, record.seq[rng[0] - 1 : rng[1]].upper()))
            if get_hit_loci:
                res.hit_loci.append(rng[0] + genome_pos)
            prev_range = rng
            return True

        replay_omn(streams, dist0s, thr_vec, k, windowsizes, seq_len, process)
        genome_pos += seq_len
        if ckpt:
            ckpt.record_done(record_idx, genome_pos, res.hits[hits_before:], res.hit_loci[loci_before:])

    if ckpt:
        ckpt.done()
    stats.hits = len(res.hits)
    stats.wall_seconds = time.perf_counter() - t_start
    if do_return_dists:
        res.dists = [np.concatenate(parts) if parts else np.empty(0) for parts in dist_parts]
    return res
