"""Strobemer genome miner on the PyTorch scan (counterpart of
``kmergma_tpu.models.strobe_miner``; ref KmerGMA.jl
src/StrobemerGMA/StrobeGenomeMiner.jl and StrobeRefGen.jl).

Per contig (records shorter than the windowsize are skipped without
advancing ``GenomePos``, as the reference's ``continue`` does):
  1. device: the record's int8 genome codes cross once (or are already
     there, ``genome_dev``), the randstrobe codes are extracted on the card
     (``strobe_2_mer_codes_torch``), and the span engine of the record's x*
     (``StrobeSpanEngine``, exact mode by default: K4 at depth ws - k, then
     the single-profile planned pass with K2) emits the sparse candidate
     stream without the codes leaving the card,
  2. host: exact replay of the minima state machine (``replay_single``,
     CMI = the raw step index),
  3. host: the batched alignment trim with StrobeGMA's score model and its
     alignment-score filter,
  4. hit records formatted exactly like the reference.

The reference's drift-bug recurrence is replicated exactly, including its
off-by-one right-boundary anchor (see ops/scan_strobe.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.align import align_hits_batch
from ..ops.consensus import Profile
from ..ops.scan import ScanEngine, resolve_device
from ..ops.strobemers import strobe_2_mer_codes, strobe_2_mer_codes_torch, ungapped_strobe_2_mer_count_into
from ..utils import trace
from ..utils.fasta import PathOrRecords, as_records
from .miner import MineResult, RecordScan, add_hits, genome_name, hit_windows, mine_records


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
    strobemer code alphabet.  It runs in exact mode (``bound_depth=None``)
    by default: with only 4^(2s) = 256 strobe values at s = 2, equal pairs
    are so common that a depth-16 bound prunes almost nothing, while the
    exact distances of K4 at depth ws - k prune perfectly.  A bounded
    engine (``bound_depth=16``, as the JAX engine takes it) runs K4 at that
    depth: K1 reads 2-bit codes, and a strobe code is a byte or more.
    Strobe codes cross as uint8 up to 256 codes and as int32 beyond (s = 3:
    4096 codes).  ``chunk_windows`` is ``ScanEngine``'s.
    """

    def __init__(self, strobe_profile: StrobeProfile, xstar: int, chunk_windows: int | None = None, bound_depth: int | None = None, *, device: "str | torch.device" = "cuda"):
        p = strobe_profile
        w = p.windowsize - p.k  # the reference's effective rolling width
        s_mod = p.sum_kfv.astype(np.int64).copy()
        s_mod[xstar] -= p.n_records
        super().__init__(s_mod, k=1, ws=w, r=p.n_records, device=device, bound_depth=bound_depth,
                         chunk_windows=chunk_windows)
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
    chunk_windows: int | None = None,
    checkpoint_path: str | None = None,
    genome_dev: "list | None" = None,
    device_extract: bool | None = None,
    engine_cache: "dict | None" = None,
    *,
    device: "str | torch.device" = "cuda",
    engine_factory=None,
) -> MineResult:
    """Mine a genome with the strobemer span engine on ``device`` (the card
    unless the caller asks for the CPU).

    With ``device_extract`` each record crosses to the device as int8
    genome codes and the strobemer extraction feeds the span engine there;
    ``device_extract=False`` extracts on the host and ships the strobe
    codes.  The default, None, extracts on the device when ``device`` is a
    card or ``genome_dev`` is given (the JAX rule: on the accelerator).
    ``genome_dev[i]``, where given, is record i's int8 genome codes already
    on the device (at least the record's length; the bench's synthetic
    genomes): the extraction reads it and nothing crosses to the device.
    ``engine_cache`` is the caller's dict of span engines by x*, kept
    across calls (at most 16 engines; a full cache is emptied before the
    next is added).  ``engine_factory(profile, xstar)`` builds the span
    engine of one x* (by default ``StrobeSpanEngine`` with
    ``chunk_windows``); any object with its ``record_stream(codes, thr,
    collect_dists)`` may take its place, such as an exact int64 host
    oracle (with ``device_extract=False``).  ``checkpoint_path`` checkpoints and
    resumes per record, as ``mine_genome``'s does (a record too short to
    scan does not advance ``GenomePos``)."""
    from ..ops.scan_strobe import strobe_scan_from_codes
    from .state_machine import candidate_stream_from_dists, replay_single

    dev = resolve_device(device)
    if device_extract is None:
        device_extract = dev.type == "cuda" or genome_dev is not None
    if engine_factory is None:
        def engine_factory(p, xstar):
            return StrobeSpanEngine(p, xstar, chunk_windows=chunk_windows, device=dev)

    s, w_min, w_max, q = profile.s, profile.w_min, profile.w_max, profile.q
    k = profile.k
    ws = profile.windowsize
    r = profile.n_records
    w = ws - k
    scale = 2.0 * k * r * r
    consensus_ws = profile.consensus[:ws]

    res = MineResult()
    dist_parts: list[np.ndarray] = []
    # one span engine per x* (usually one)
    engines: dict[int, object] = engine_cache if engine_cache is not None else {}

    def scan(rec: RecordScan) -> None:
        record, seq_len = rec.record, len(rec.record)
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
                    gcodes = genome_dev[rec.idx][:seq_len]
                else:
                    with trace.span("stage") as sp_stage:
                        sp_stage.add(bytes=seq_len)
                        gcodes = torch.from_numpy(record.codes).to(dev)
            with trace.span("extract") as sp_extract:
                if device_extract:
                    sc = strobe_2_mer_codes_torch(gcodes, s, w_min, w_max, q)
                else:
                    sc = strobe_2_mer_codes(record.codes, s, w_min, w_max, q)
                # reading x* waits for a device extraction to finish
                xstar = int(sc[w])
                sp_extract.add(bp=seq_len, windows=int(sc.shape[0]))
            eng = engines.get(xstar)
            if eng is None:
                with trace.span("engine") as sp_engine:
                    if len(engines) > 16:
                        engines.clear()
                    eng = engines[xstar] = engine_factory(profile, xstar)
                    sp_engine.add(xstar=xstar)
                trace.add_to_call(engines_built=1)
            dist0, stream, dists = eng.record_stream(sc[: n_steps + w], thr, collect_dists=do_return_dists)
        rec.scanned(n_steps + 1, len(stream))
        if do_return_dists:
            dist_parts.append(np.asarray(dists[1:]) if dists is not None else np.empty(0))

        with trace.span("replay") as sp_replay:
            raw_hits = replay_single(
                stream, dist0, thr,
                k=k, ws=ws, seq_len=seq_len, buff=buff, cmi_offset=0,
            )
            sp_replay.add(hits=len(raw_hits))
        res.stats.replay_hits += len(raw_hits)
        alns = None
        if do_align and raw_hits:
            windows = hit_windows(record, raw_hits)
            res.stats.windows_aligned += len(windows)
            alns = align_hits_batch(consensus_ws, windows, gap_open, gap_extend, device=dev)
        rec.span.add(score_filtered=add_hits(res, rec, raw_hits, alns, keep_align=do_return_align,
                                             keep_loci=get_hit_loci, min_score=score_threshold))

    # ref StrobeGenomeMiner.jl:36: `continue` on a record shorter than ws
    # skips genome_pos too
    mine_records(res, lambda: as_records(genome),
                 f"strobe|{genome_name(genome)}|s={s}|wmin={w_min}|wmax={w_max}|q={q}|ws={ws}|thr={thr}",
                 checkpoint_path, scan, min_len=ws)
    if do_return_dists:
        res.dists = np.concatenate(dist_parts) if dist_parts else np.empty(0)
    return res
