"""Strobemer genome miner on the PyTorch scan (counterpart of
``kmergma_tpu.models.strobe_miner``; ref KmerGMA.jl
src/StrobemerGMA/StrobeGenomeMiner.jl and StrobeRefGen.jl).

Per contig (records shorter than the windowsize are skipped without
advancing ``GenomePos``, as the reference's ``continue`` does):
  1. device: the record's int8 genome codes cross once (or are already
     there, ``genome_dev``), the randstrobe codes are extracted on the card
     (``strobe_2_mer_codes_torch``), and the span engine of the record's x*
     (``StrobeSpanEngine``, exact mode: K4 at depth ws - k, then the
     single-profile planned pass with K2) emits the sparse candidate stream
     without the codes leaving the card,
  2. host: exact replay of the minima state machine (``replay_single``,
     CMI = the raw step index),
  3. host: the batched alignment trim with StrobeGMA's score model and its
     alignment-score filter,
  4. hit records formatted exactly like the reference.

The reference's drift-bug recurrence is replicated exactly, including its
off-by-one right-boundary anchor (see ops/scan_strobe.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.align import align_hits_batch, cigar_to_unitrange
from ..ops.consensus import Profile
from ..ops.scan import ScanEngine, resolve_device
from ..ops.strobemers import strobe_2_mer_codes, strobe_2_mer_codes_torch, ungapped_strobe_2_mer_count_into
from ..utils.checkpoint import ScanCheckpoint
from ..utils.fasta import FastaRecord, PathOrRecords, as_records
from .miner import MineResult, ScanStats, fmt_dist


@dataclass
class StrobeProfile:
    mean_kfv: np.ndarray  # float64[4^(2s)]
    sum_kfv: np.ndarray  # int64[4^(2s)], exact integer sum (scan path)
    n_records: int
    windowsize: int
    consensus: str
    s: int
    w_min: int
    w_max: int
    q: int

    @property
    def k(self) -> int:
        return self.w_max + self.s - 1


def gen_strobe_ref_ws_cons(
    source: PathOrRecords, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5
) -> StrobeProfile:
    """Strobemer-spectrum analogue of gen_ref_ws_cons (ref StrobeRefGen.jl:4-43)."""
    records = as_records(source)
    if not records:
        raise ValueError("reference set is empty")
    sums = np.zeros(4 ** (2 * s), dtype=np.float64)
    profile = Profile(1)
    n, cum = 0, 0
    for rec in records:
        n += 1
        cum += len(rec)
        ungapped_strobe_2_mer_count_into(rec.codes, sums, s, w_min, w_max, q)
        profile.lengthen(len(rec))
        profile.add(rec.codes)
    inv = 1.0 / n
    return StrobeProfile(
        mean_kfv=sums * inv,
        sum_kfv=sums.astype(np.int64),
        n_records=n,
        windowsize=int(np.round(cum * inv)),
        consensus=profile.consensus_str(),
        s=s,
        w_min=w_min,
        w_max=w_max,
        q=q,
    )


class StrobeSpanEngine(ScanEngine):
    """The StrobeGMA recurrence as a k = 1 spectrum scan.

    The reference's drift-bug recurrence evolves counts c_j =
    slidingcount_w(K, j) + e_x with x = K[w] the persistently double-counted
    strobemer, so its distance is exactly

        D[j] = || r (u_j + e_x) - S ||^2  =  || r u_j - (S - r e_x) ||^2

    - a plain width-w sliding spectrum distance against the modified profile
    S - r e_x, so the single-profile engine applies with k = 1 over the
    strobemer code alphabet.  It runs in exact mode (``bound_depth=None``):
    with only 4^(2s) = 256 strobe values at s = 2, equal pairs are so common
    that a depth-16 bound prunes almost nothing, while the exact distances
    of K4 at depth ws - k prune perfectly.  Strobe codes cross as uint8 up
    to 256 codes and as int32 beyond (s = 3: 4096 codes).
    """

    def __init__(self, strobe_profile: StrobeProfile, xstar: int, device: "str | torch.device" = "cuda"):
        p = strobe_profile
        w = p.windowsize - p.k  # the reference's effective rolling width
        s_mod = p.sum_kfv.astype(np.int64).copy()
        s_mod[xstar] -= p.n_records
        super().__init__(s_mod, k=1, ws=w, r=p.n_records, device=device, bound_depth=None)
        self.codes_dtype = np.uint8 if 4 ** (2 * p.s) <= 256 else np.int32
        # distances are reported in the reference's 1/(2 k_eff r^2) unit
        self.scale = 2.0 * p.k * p.n_records * p.n_records


def strobe_mine_genome(
    genome: PathOrRecords,
    profile: StrobeProfile,
    thr: float = 33.5,
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -69,
    gap_extend: int = -5,  # StrobeGMA's default score model (StrobeGenomeMiner.jl:17)
    score_threshold: int = 0,
    do_return_dists: bool = False,
    do_return_align: bool = False,
    get_hit_loci: bool = False,
    checkpoint_path: str | None = None,
    genome_dev: "list | None" = None,
    device_extract: bool = True,
    engine_cache: "dict | None" = None,
    device: "str | torch.device" = "cuda",
    engine_factory=None,
) -> MineResult:
    """Mine a genome with the strobemer span engine on ``device`` (the card
    unless the caller asks for the CPU).

    With ``device_extract`` (the default) each record crosses to the device
    as int8 genome codes and the strobemer extraction feeds the span engine
    there; ``device_extract=False`` extracts on the host and ships the
    strobe codes.  ``genome_dev[i]``, where given, is record i's int8
    genome codes already on the device (at least the record's length; the
    bench's synthetic genomes): the extraction reads it and nothing
    crosses to the device.  ``engine_cache`` is the caller's dict of span
    engines by x*, kept across calls (at most 16 engines; a full cache is
    emptied before the next is added).  ``engine_factory(profile, xstar)``
    builds the span engine of one x* (by default ``StrobeSpanEngine``); any
    object with its ``record_stream(codes, thr, collect_dists)`` may take
    its place, such as an exact int64 host oracle (with
    ``device_extract=False``).  ``checkpoint_path`` checkpoints and
    resumes per record, as ``mine_genome``'s does (a record too short to
    scan does not advance ``GenomePos``)."""
    from ..ops.scan_strobe import strobe_scan_from_codes
    from .state_machine import candidate_stream_from_dists, replay_single

    dev = resolve_device(device)
    if engine_factory is None:
        def engine_factory(p, xstar):
            return StrobeSpanEngine(p, xstar, device=dev)

    s, w_min, w_max, q = profile.s, profile.w_min, profile.w_max, profile.q
    k = profile.k
    ws = profile.windowsize
    r = profile.n_records
    w = ws - k
    scale = 2.0 * k * r * r
    consensus_ws = profile.consensus[:ws]

    res = MineResult()
    res.stats = stats = ScanStats()
    t_start = time.perf_counter()
    dist_parts: list[np.ndarray] = []
    # one span engine per x* (usually one)
    engines: dict[int, object] = engine_cache if engine_cache is not None else {}

    ckpt = None
    if checkpoint_path is not None:
        genome_id = (
            f"strobe|{genome if isinstance(genome, str) else 'records'}"
            f"|s={s}|wmin={w_min}|wmax={w_max}|q={q}|ws={ws}|thr={thr}"
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
        if seq_len < ws:
            # ref StrobeGenomeMiner.jl:36: `continue` skips genome_pos too
            stats.records_skipped += 1
            if ckpt:
                ckpt.record_done(record_idx, genome_pos, [], [])
            continue
        n_steps = seq_len - ws - 1
        if n_steps < 1:
            # degenerate record: only the init window exists
            sc = strobe_2_mer_codes(record.codes, s, w_min, w_max, q)
            sprof = torch.as_tensor(profile.sum_kfv.astype(np.int32), device=dev)
            d_scaled = strobe_scan_from_codes(
                torch.as_tensor(sc.astype(np.int32), device=dev), sprof, w, r, max(n_steps, 0)
            ).cpu().numpy()
            dists = d_scaled.astype(np.float64) / scale
            dist0, stream = float(dists[0]), list(candidate_stream_from_dists(dists, thr))
        else:
            if device_extract:
                # the record crosses as int8 genome codes (or is already on
                # the device); the strobe codes feed the span engine without
                # leaving the device
                if genome_dev is not None:
                    gcodes = genome_dev[record_idx][:seq_len]
                else:
                    gcodes = torch.from_numpy(record.codes).to(dev)
                sc = strobe_2_mer_codes_torch(gcodes, s, w_min, w_max, q)
            else:
                sc = strobe_2_mer_codes(record.codes, s, w_min, w_max, q)
            xstar = int(sc[w])
            eng = engines.get(xstar)
            if eng is None:
                if len(engines) > 16:
                    engines.clear()
                eng = engines[xstar] = engine_factory(profile, xstar)
            dist0, stream, dists = eng.record_stream(sc[: n_steps + w], thr, collect_dists=do_return_dists)
        stats.records_scanned += 1
        stats.bp_scanned += seq_len
        stats.windows_scanned += n_steps + 1
        stats.candidate_windows += len(stream)
        if do_return_dists:
            dist_parts.append(np.asarray(dists[1:]) if dists is not None else np.empty(0))

        raw_hits = replay_single(
            stream, dist0, thr,
            k=k, ws=ws, seq_len=seq_len, buff=buff, cmi_offset=0,
        )

        alns = None
        if do_align and raw_hits:
            windows = [
                record.seq[h.start - 1 : h.stop].decode("ascii").upper()
                for h in raw_hits
            ]
            alns = align_hits_batch(consensus_ws, windows, gap_open, gap_extend)
        for hit_i, hit in enumerate(raw_hits):
            lo, hi = hit.start, hit.stop
            rng = (lo, hi)
            if do_align:
                aln = alns[hit_i]
                if aln.score < score_threshold:
                    continue  # ref Alignment.jl:96-98 score filter
                if do_return_align:
                    res.alignments.append(aln)
                alo, ahi = cigar_to_unitrange(aln)
                rng = (max(1, lo + alo - 1), min(lo + ahi - 1, seq_len))
            desc = (
                f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
                f" | MatchPos = {rng[0]}:{rng[1]}"
                f" | GenomePos = {genome_pos}"
                f" | Len = {rng[1] - rng[0] + 1}"
            )
            res.hits.append(FastaRecord(desc, record.seq[rng[0] - 1 : rng[1]].upper()))
            if get_hit_loci:
                res.hit_loci.append(rng[0] + genome_pos)
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
