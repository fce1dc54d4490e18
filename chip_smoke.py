#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kmergma_tpu_torch/csrc`` (into
``build/kmergma_tpu_torch/``) and drives both paths of the port:

* single profile: K1 and K2 against their plain PyTorch twins on the card
  at the main path's shapes (bit-identical: the scan is integer
  arithmetic), the golden hits through ``kmergma_tpu_torch.find_genes``,
  then a 64 Mbp synthetic genome (four 16 Mbp contigs of hashed background
  with the 84 Alp_V reference genes planted every 500 kb) mined against the
  JAX-free int64 host oracle, and where one call's wall goes: each stage
  timed alone, and the device's busy share of one profiled call;
* cluster mode (the Alp_V set in six clusters): K3, K8 and K5 against
  their twins, the cluster goldens through ``find_genes_cluster_mode``
  (the split route, so K5), both routes on one record, then the same
  genome plus one short contig (the split route again) mined against an
  int64 host cluster oracle, and where one call's wall goes, stage by
  stage and on the device.

Each path's kernels are shown to have launched in that path's run: their
launch counts are set to 0 just before it and read just after.

It imports only the port (``kmergma_tpu_torch``); the JAX package's
JAX-free host modules that the port shares (FASTA, reference profile,
threshold, int64 host engine) come through ``kmergma_tpu_torch.host``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Its last line is
``{"ok": true, "device": {...}}``; before it the kernels' JSON and the
card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
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
#: the cluster path's extra contig: shorter than K3's cutover of 65,536
#: windows, so it takes the split route (K5)
SHORT_CONTIG_BP = 60_000


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
        from kmergma_tpu_torch.host import HostScanEngine

        self.engines = [HostScanEngine(p.sum_kfv, k=k, ws=p.windowsize, r=p.n_records) for p in profiles]

    def record_streams(self, codes, thrs):
        return [e.record_stream(codes, thr)[:2] for e, thr in zip(self.engines, thrs)]


def clock(fn, sync):
    """(wall ms, result) of one call of ``fn`` between device synchronises."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def timed_ms(fn, sync, reps: int = 5):
    """Median wall time of ``fn`` in ms over ``reps`` runs after one
    warm-up, with ``sync`` (the device synchronise) around each run;
    returns (ms, last result)."""
    out = fn()
    sync()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def stage_breakdown(fasta: Path, profile, thr: float, wall_s: float, sync, on_card: bool, label: str, reps: int = 3) -> None:
    """Print where one ``find_genes`` call on ``fasta`` spends its wall.

    Each stage of the call runs alone with a device synchronise around it
    (median of ``reps`` over all records); shares are of ``wall_s``, the
    unprofiled median wall.  Then one call runs under torch.profiler, after
    a first profiled call that only starts the tracer: the device's busy
    time (the union of its kernel, copy and fill intervals) and the wall
    are both read from that one call."""
    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.host import (
        as_records, estimate_optimal_threshold, gen_ref_ws_cons, replay_single, semiglobal_align_batch,
    )
    from kmergma_tpu_torch.ops.scan import ScanEngine

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
        ms[names[3]], engine = clock(lambda: ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device="cuda" if on_card else "cpu"), sync)
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
    print(f"stage breakdown of one find_genes call, median of {reps} per stage, shares of the "
          f"{wall_s * 1e3:.3f} ms median wall [{label}]:")
    staged = 0.0
    for i, name in enumerate(names):
        med = statistics.median(run_ms[name] for run_ms in runs)
        if i != 6:
            staged += med
        print(f"  {name:<52} {med:10.3f} ms  {100 * med / (wall_s * 1e3):6.2f}%")
    print(f"  {'sum of the stages (K1 alone not added)':<52} {staged:10.3f} ms  {100 * staged / (wall_s * 1e3):6.2f}%")

    device_share("find_genes", lambda: kt.find_genes(str(fasta), REF, verbose=False), sync, on_card, label)


def cluster_stage_breakdown(fasta: Path, thrs: list, wall_s: float, sync, device, label: str, reps: int = 3) -> None:
    """Print where one ``find_genes_cluster_mode`` call on ``fasta`` spends
    its wall, each stage run alone with a device synchronise around it,
    median of ``reps`` over all records; shares are of ``wall_s``.  The
    replay and the alignment are timed through ``mine_genome_clusters`` on
    the streams already computed (without, then with, the alignment)."""
    from kmergma_tpu_torch.host import as_records, cluster_ref_api, eliminate_null_params, estimate_optimal_thresholds
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.ops.scan import _planned_streams
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine

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
    print(f"stage breakdown of one find_genes_cluster_mode call, median of {reps} per stage, shares of the "
          f"{wall_s * 1e3:.3f} ms median wall [{label}]:")
    staged = 0.0
    for name in names:
        med = statistics.median(run_ms[name] for run_ms in runs)
        staged += med
        print(f"  {name:<62} {med:10.3f} ms  {100 * med / (wall_s * 1e3):6.2f}%")
    print(f"  {'sum of the stages':<62} {staged:10.3f} ms  {100 * staged / (wall_s * 1e3):6.2f}%")


def device_share(what: str, call, sync, on_card: bool, label: str) -> None:
    """Run ``call`` under torch.profiler, after a first profiled call that
    only starts the tracer, and print the device's busy time (the union of
    its kernel, copy and fill intervals) and the wall, both from that one
    call, with the ten largest device totals by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

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


def run(device, contig_bp: int = 16_000_000, n_contigs: int = 4, plant_every: int = 500_000, whole_bp: int = 4_000_000, runs: int = 3, label: str = "") -> dict:
    """All phases on ``device``; raises SmokeFailure on any failed check.
    ``runs`` timed runs follow one warm-up at size, and each stage of the
    breakdowns is the median of ``runs``.  Returns the kernels' report."""
    import numpy as np
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch import _kernels
    from kmergma_tpu_torch.host import (
        HostScanEngine, as_records, cluster_ref_api, eliminate_null_params, estimate_optimal_threshold,
        estimate_optimal_thresholds, gen_ref_ws_cons, scan_rolling_i64_native,
    )
    from kmergma_tpu_torch.models.miner import mine_genome
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.ops.scan import (
        ScanEngine, _first_window_l0, _plan_regions, rolling_kmer_codes, scan_window_distances,
    )
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.scan_cluster_fused import (
        _lookup_roundtrip_plain, cluster_tables_in_smem, fused_cluster_record_bitmaps,
        fused_cluster_record_bitmaps_plain, lookup_roundtrip,
    )
    from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps, fused_record_bitmaps_plain
    from kmergma_tpu_torch.ops.scan_kernels import (
        _codes_pair_multi_plain, _match_counts_plain, codes_pair_multi, match_counts,
        scan_window_distances_kernel,
    )

    wrappers = {
        "fused_record_bitmaps": fused_record_bitmaps, "match_counts": match_counts,
        "fused_cluster_record_bitmaps": fused_cluster_record_bitmaps,
        "codes_pair_multi": codes_pair_multi, "lookup_roundtrip": lookup_roundtrip,
    }

    def reset_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # --- build -------------------------------------------------------
    if on_card:
        lib_path, log_path = _kernels.paths()
        built = not lib_path.exists()
        t0 = time.perf_counter()
        _kernels.load()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s (compiled now: {built}, {lib_path}) [{label}]")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"  ptxas: {line.strip()}")

    profile = gen_ref_ws_cons(REF, 6)
    k, ws, r = profile.k, profile.windowsize, profile.n_records
    thr = estimate_optimal_threshold(profile.mean_kfv, ws, buffer=8.0)
    genes = [rec.codes for rec in as_records(REF)]
    contigs = synthetic_genome(n_contigs, contig_bp, plant_every, genes)
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
    k1_ms, bm = timed_ms(lambda: fused_record_bitmaps(prep, engine.s_dev, thr_int, l0, nw, **kw), sync)
    k1_plain_ms, bm_plain = timed_ms(lambda: fused_record_bitmaps_plain(prep, engine.s_dev, thr_int, l0, nw, **kw), sync)
    k1_err = int((bm - bm_plain).abs().max())
    n_active = int(bm.sum())
    print(
        f"K1 fused_record_bitmaps, {record.shape[0]} bp record, k={k} ws={ws} depth={depth} "
        f"thr_int={thr_int}: {k1_ms:.3f} ms, plain twin {k1_plain_ms:.3f} ms, "
        f"bit-identical={k1_err == 0}, active blocks {n_active}/{bm.numel()} [{label}]"
    )
    require(k1_err == 0, "K1 bitmap differs from its plain twin")
    require(n_active > 0, "K1 flagged no block on a record with planted genes")

    # --- K2 vs its plain twin: the main path's region rows --------------
    rspan = engine.rspan
    w = ws - k + 1
    starts, nvr = _plan_regions(bm.reshape(-1).bool(), nw, rspan, engine.block, 256)
    rows = prep[starts[:, None] + torch.arange(rspan + ws - 1, device=device)[None, :]]
    tiles = torch.nn.functional.pad(rolling_kmer_codes(rows, k), (0, 1))
    k2_ms, ab = timed_ms(lambda: match_counts(tiles, w, rspan), sync)
    k2_plain_ms, ab_plain = timed_ms(lambda: _match_counts_plain(tiles, w, rspan), sync)
    k2_err = int((ab - ab_plain).abs().max())
    print(
        f"K2 match_counts, {tiles.shape[0]} region rows x {tiles.shape[1]} K codes "
        f"({int(nvr)} active regions): {k2_ms:.3f} ms, plain twin {k2_plain_ms:.3f} ms, "
        f"bit-identical={k2_err == 0} [{label}]"
    )
    require(k2_err == 0, "K2 region rows differ from the plain twin")

    # --- K2 on a whole-record distance scan ------------------------------
    whole = prep[: whole_bp + ws - 1]
    kd_ms, d_kernel = timed_ms(lambda: scan_window_distances_kernel(whole, engine.s_dev, k, ws, r), sync)
    pd_ms, d_plain = timed_ms(lambda: scan_window_distances(whole, engine.s_dev, k, ws, r), sync)
    kd_err = int((d_kernel - d_plain).abs().max())
    oracle = scan_rolling_i64_native(record[: whole_bp + ws - 1], profile.sum_kfv, k, ws, r)
    oracle_ok = oracle is None or np.array_equal(d_kernel.cpu().numpy().astype(np.int64), oracle)
    print(
        f"K2 whole-record distances, {whole_bp} windows (tiles of 2048): {kd_ms:.3f} ms, "
        f"plain twin {pd_ms:.3f} ms, bit-identical={kd_err == 0}, "
        f"int64 host oracle {'agrees' if oracle is not None and oracle_ok else 'unavailable' if oracle is None else 'DIFFERS'} [{label}]"
    )
    require(kd_err == 0 and oracle_ok, "K2 whole-record distances differ")
    del prep, bm, bm_plain, rows, tiles, whole, d_kernel, d_plain

    # --- goldens through find_genes ------------------------------------------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hits = kt.find_genes(str(DATA / "Alp_V_locus.fasta"), REF, verbose=False)[0]
        require([h.description for h in hits] == GOLDEN_LOCUS, "Alp_V_locus golden hits")
        hits, loci = kt.find_genes(str(DATA / "Loci.fasta"), REF, verbose=False, do_return_hit_loci=True)
        require(len(hits) == 7 and loci == GOLDEN_LOCI, f"Loci golden: {len(hits)} hits, loci {loci}")
        hits, dists = kt.find_genes(
            str(DATA / "Loci.fasta"), REF, kmer_dist_thr=10, do_align=False,
            do_return_dists=True, verbose=False,
        )
        require(dists.shape[0] == 484127 and round(float(dists.mean())) == 46 and len(hits) == 3,
                f"Loci distances golden: {dists.shape[0]} dists, mean {float(dists.mean())}, {len(hits)} hits")
    print("goldens: Alp_V_locus 3 hits exact; Loci 7 hits, loci as pinned; "
          f"Loci do_return_dists {dists.shape[0]} distances, mean {float(dists.mean()):.4f}")

    # --- the main path at size: find_genes on the synthetic genome ----------
    total_bp = sum(c.shape[0] for c in contigs)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = Path(tmp) / "genome.fasta"
        write_fasta(fasta, contigs)
        reset_counts()
        times = []
        for i in range(runs + 1):  # one warm-up, then the timed runs
            sync()
            t0 = time.perf_counter()
            hits = kt.find_genes(str(fasta), REF, verbose=False)[0]
            sync()
            if i:
                times.append(time.perf_counter() - t0)
        launches = read_counts()
        t_med = statistics.median(times)
        print(
            f"find_genes {total_bp} bp ({n_contigs} contigs): median of {runs} {t_med:.3f} s "
            f"= {total_bp / t_med / 1e6:.2f} Mbp/s (runs {', '.join(f'{x:.3f}' for x in times)} s), "
            f"{len(hits)} hits [{label}]"
        )
        t0 = time.perf_counter()
        oracle_res = mine_genome(
            str(fasta), profile, thr=thr,
            engine=HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r),
        )
        print(f"int64 host oracle (HostScanEngine): {time.perf_counter() - t0:.3f} s, {len(oracle_res.hits)} hits [{label}]")
        stage_breakdown(fasta, profile, thr, t_med, sync, on_card, label, reps=runs)
    require(len(hits) > 0, "no hits on the planted genome")
    require(
        [(h.description, h.seq) for h in hits] == [(h.description, h.seq) for h in oracle_res.hits],
        "find_genes hits differ from the int64 host oracle",
    )
    print(f"hits equal the host oracle's; launch counts over the {runs + 1} runs: {launches}")
    if on_card:
        require(launches["fused_record_bitmaps"] > 0 and launches["match_counts"] > 0,
                f"a kernel of the single-profile path never launched: {launches}")

    # --- cluster mode: the Alp_V set in six clusters -------------------------
    clusters = eliminate_null_params(cluster_ref_api(REF, 6))
    profiles = clusters.profiles
    cthrs = estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0)
    ceng = ClusterScanEngine(profiles, k=6, device=device)
    m = len(profiles)
    widths = [ws_c - k + 1 for ws_c, _r in ceng.specs]
    print(
        f"cluster mode: {m} clusters, windowsizes {clusters.windowsizes}, R {[p.n_records for p in profiles]}, "
        f"{len(ceng.groups)} windowsize groups, pair depth {ceng.depth}, auto thresholds (buffer 7) {cthrs} [{label}]"
    )

    # --- K3 vs its plain twin: one whole contig, all clusters --------------
    record = contigs[0]
    nws = [record.shape[0] - ws_c + 1 for ws_c, _r in ceng.specs]
    cprep = ceng.prepare_codes(record)
    cthr_ints = [int(e._thr_int(x)) for e, x in zip(ceng.engines, cthrs)]
    l0s = torch.stack([
        _first_window_l0(cprep, e.s_dev, k=k, ws=e.ws, r=e.r, depth=ceng.depth) for e in ceng.engines
    ])
    kw3 = dict(k=k, specs=ceng.specs, depth=ceng.depth, t=ceng.fused_t, block=ceng.block,
               n_tiles=-(-max(nws) // ceng.fused_t))
    k3_ms, bm3 = timed_ms(lambda: fused_cluster_record_bitmaps(cprep, ceng.s_stack, cthr_ints, l0s, nws, **kw3), sync)
    k3_plain_ms, bm3_plain = timed_ms(
        lambda: fused_cluster_record_bitmaps_plain(cprep, ceng.s_stack, cthr_ints, l0s, nws, **kw3), sync
    )
    k3_err = int((bm3 - bm3_plain).abs().max())
    placement = "the plain twin's gather"
    if on_card:
        placement = "shared memory" if cluster_tables_in_smem(m, k, ceng.fused_t, min(widths), max(widths)) else "__ldg"
    print(
        f"K3 fused_cluster_record_bitmaps, {record.shape[0]} bp record, {m} clusters, tables read through {placement}: "
        f"{k3_ms:.3f} ms, plain twin {k3_plain_ms:.3f} ms, bit-identical={k3_err == 0}, "
        f"active blocks per cluster {[int(x) for x in bm3.sum(dim=1)]} of {bm3.shape[1]} [{label}]"
    )
    require(k3_err == 0, "K3 bitmaps differ from the plain twin")
    require(int(bm3.sum()) > 0, "K3 flagged no block on a record with planted genes")

    # --- K8: every table entry through K3's lookup ------------------------
    rt = dict(t=ceng.fused_t, w_min=min(widths), w_max=max(widths))
    k8_ms, back = timed_ms(lambda: lookup_roundtrip(ceng.s_stack, **rt), sync)
    k8_plain_ms, back_plain = timed_ms(lambda: _lookup_roundtrip_plain(ceng.s_stack), sync)
    k8_err = max(int((back - ceng.s_stack).abs().max()), int((back - back_plain).abs().max()))
    print(
        f"K8 lookup_roundtrip, {m} x {4**k} entries: {k8_ms:.3f} ms, plain twin {k8_plain_ms:.3f} ms, "
        f"equal to the stack={k8_err == 0} [{label}]"
    )
    require(k8_err == 0, "K8 read a table entry back wrong")
    del cprep, bm3, bm3_plain, back, back_plain

    # --- K5 vs its plain twin: the split pass's shapes ----------------------
    ws_groups = tuple(g[0] for g in ceng.groups)
    k5 = {}
    for n_bp in (SHORT_CONTIG_BP, whole_bp):
        pp = ceng.prepare_codes(record[:n_bp])
        span = ceng._split_span(n_bp - min(clusters.windowsizes) + 1)
        args = (pp, k, ws_groups, span - 1, span + max(widths) - 1, ceng.depth)
        ms, (ab5, kc5) = timed_ms(lambda: codes_pair_multi(*args), sync)
        pms, (ab5p, kc5p) = timed_ms(lambda: _codes_pair_multi_plain(*args), sync)
        err = max(int((ab5 - ab5p).abs().max()), int((kc5 - kc5p).abs().max()))
        k5[n_bp] = (ms, pms, err)
        print(
            f"K5 codes_pair_multi, {n_bp} bp record, span {span}, groups {ws_groups}, depth {ceng.depth}: "
            f"{ms:.3f} ms, plain twin {pms:.3f} ms, bit-identical={err == 0} [{label}]"
        )
        require(err == 0, f"K5 differs from its plain twin on a {n_bp} bp record")
    k5_err = max(v[2] for v in k5.values())

    # --- cluster goldens through find_genes_cluster_mode (the split route) --
    reset_counts()
    hits = kt.find_genes_cluster_mode(
        str(DATA / "Alp_V_locus.fasta"), REF, kmer_dist_thrs=GOLDEN_CLUSTER_THRS, buffer=100, verbose=False,
    )[0]
    golden_launches = read_counts()
    require([h.description for h in hits] == GOLDEN_CLUSTER, "Alp_V_locus cluster golden hits")
    print(f"cluster goldens: Alp_V_locus 3 hits exact; launch counts {golden_launches} [{label}]")
    if on_card:
        require(golden_launches["codes_pair_multi"] > 0 and golden_launches["match_counts"] > 0,
                f"the cluster golden did not run K5 and K2: {golden_launches}")

    # --- both routes agree ------------------------------------------------------
    # the cluster path's short contig (hashed background, three genes) takes
    # the split route by default; a whole contig takes K3 by default
    short_contig = hash_codes(SHORT_CONTIG_BP, n_contigs * contig_bp, seed=1)
    for j, pos in enumerate(range(10_000, SHORT_CONTIG_BP - 1_000, 20_000)):
        short_contig[pos : pos + genes[j].shape[0]] = genes[j]
    for codes_r, other in ((short_contig, 1), (record, 1 << 30)):
        a = ClusterScanEngine(profiles, k=6, device=device)
        b = ClusterScanEngine(profiles, k=6, device=device)
        b.fused_min_windows = other
        sa, sb = a.record_streams(codes_r, cthrs), b.record_streams(codes_r, cthrs)
        require(sa == sb, f"K3 and split-route streams differ on a {codes_r.shape[0]} bp record")
        require(any(x[1] for x in sa), f"no cluster stream entries on a {codes_r.shape[0]} bp record with planted genes")
        print(f"both routes agree on a {codes_r.shape[0]} bp record: {[len(x[1]) for x in sa]} stream entries [{label}]")

    # --- the cluster path at size ------------------------------------------------
    ccontigs = [*contigs, short_contig]
    ctotal = sum(c.shape[0] for c in ccontigs)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = Path(tmp) / "genome.fasta"
        write_fasta(fasta, ccontigs)
        reset_counts()
        times = []
        for i in range(runs + 1):  # one warm-up, then the timed runs
            sync()
            t0 = time.perf_counter()
            chits = kt.find_genes_cluster_mode(str(fasta), REF, verbose=False)[0]
            sync()
            if i:
                times.append(time.perf_counter() - t0)
        claunches = read_counts()
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
        device_share("find_genes_cluster_mode", lambda: kt.find_genes_cluster_mode(str(fasta), REF, verbose=False),
                     sync, on_card, label)
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

    def entry(name, source, replaces, count, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": f"kmergma_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": count, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    return {"kernels": [
        entry("fused_record_bitmaps", "fused_bitmaps.cu", "kmergma_tpu/ops/scan_fused.py:165",
              launches["fused_record_bitmaps"], k1_err, k1_ms, k1_plain_ms),
        entry("match_counts", "match_counts.cu", "kmergma_tpu/ops/scan_pallas.py:43",
              launches["match_counts"], k2_err, k2_ms, k2_plain_ms),
        entry("fused_cluster_record_bitmaps", "fused_cluster_bitmaps.cu", "kmergma_tpu/ops/scan_cluster_fused.py:187",
              claunches["fused_cluster_record_bitmaps"], k3_err, k3_ms, k3_plain_ms),
        entry("lookup_roundtrip", "fused_cluster_bitmaps.cu", "kmergma_tpu/ops/scan_cluster_fused.py:169",
              claunches["lookup_roundtrip"], k8_err, k8_ms, k8_plain_ms),
        entry("codes_pair_multi", "pair_multi.cu", "kmergma_tpu/ops/scan_pallas.py:368",
              claunches["codes_pair_multi"], k5_err, k5[SHORT_CONTIG_BP][0], k5[SHORT_CONTIG_BP][1]),
    ]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    label = card_label()
    print(f"card: {label}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    try:
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
