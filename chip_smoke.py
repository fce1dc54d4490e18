#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kmergma_tpu_torch/csrc`` (into
``build/kmergma_tpu_torch/``), holds each kernel against its plain PyTorch
twin on the card at the main path's shapes (bit-identical: the scan is
integer arithmetic), checks the golden hits through
``kmergma_tpu_torch.find_genes``, then mines a 64 Mbp synthetic genome
(four 16 Mbp contigs of hashed background with the 84 Alp_V reference genes
planted every 500 kb) against the JAX-free int64 host oracle, and shows
through the kernels' launch counts that the run went through both kernels.
Last it prints where one ``find_genes`` call's wall goes: each stage timed
alone, and the device's busy share of one profiled call.

It imports only the port (``kmergma_tpu_torch``); the JAX package's
JAX-free host modules that the port shares (FASTA, reference profile,
threshold, int64 host engine) come through ``kmergma_tpu_torch.host``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Its last line is
``{"ok": true, "device": {...}}``; the line before it the kernels' JSON.
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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.host import (
        as_records, estimate_optimal_threshold, gen_ref_ws_cons, replay_single, semiglobal_align_batch,
    )
    from kmergma_tpu_torch.ops.scan import ScanEngine

    k, ws, r = profile.k, profile.windowsize, profile.n_records

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    names = [
        "FASTA parse (as_records)", "reference profile (gen_ref_ws_cons)", "threshold estimate",
        "ScanEngine set-up (S to the device)", "H2D incl. host zero-padding (prepare_codes)",
        "planned pass: K1 + plan + K2 + run reduce + D2H", "  of which K1 bitmap alone (incl. l0, bases)",
        "replay (replay_single)", "alignment (semiglobal_align_batch)",
    ]
    runs = []
    for _ in range(reps):
        ms = dict.fromkeys(names, 0.0)
        ms[names[0]], records = clock(lambda: as_records(str(fasta)))
        ms[names[1]], _ = clock(lambda: gen_ref_ws_cons(REF, k))
        ms[names[2]], _ = clock(lambda: estimate_optimal_threshold(profile.mean_kfv, ws, buffer=8.0))
        ms[names[3]], engine = clock(lambda: ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device="cuda" if on_card else "cpu"))
        thr_int = int(engine._thr_int(thr))
        for rec in records:
            nw = len(rec) - ws + 1
            t, prep = clock(lambda: engine.prepare_codes(rec.codes))
            ms[names[4]] += t
            t, (dist0, stream) = clock(lambda: engine._planned_record(prep, nw, thr))
            ms[names[5]] += t
            t, _ = clock(lambda: engine._record_bitmap(prep, nw, thr_int))
            ms[names[6]] += t
            t, raw = clock(lambda: replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=len(rec), buff=50))
            ms[names[7]] += t
            windows = [rec.seq[h.start - 1 : h.stop].decode("ascii").upper() for h in raw]
            if windows:
                t, _ = clock(lambda: semiglobal_align_batch(profile.consensus_ws, windows, -69, -1))
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

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with torch_profile(activities=activities):
        kt.find_genes(str(fasta), REF, verbose=False)
    with torch_profile(activities=activities) as prof:
        wall_ms, _ = clock(lambda: kt.find_genes(str(fasta), REF, verbose=False))
    dev_events = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in dev_events):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    print(f"profiled find_genes call: wall {wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"(union of {len(dev_events)} device intervals), busy share {busy_us / 1e3 / wall_ms:.4f}, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.4f} [{label}]")
    totals: dict = {}
    for ev in dev_events:
        n, t = totals.get(ev.name, (0, 0.0))
        totals[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    for name, (n, t) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  device: {t / 1e3:9.3f} ms in {n:4d} x {name[:90]}")


def run(device, contig_bp: int = 16_000_000, n_contigs: int = 4, plant_every: int = 500_000, whole_bp: int = 4_000_000, label: str = "") -> dict:
    """All phases on ``device``; raises SmokeFailure on any failed check.
    Returns the kernels' report."""
    import numpy as np
    import torch

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch import _kernels
    from kmergma_tpu_torch.host import (
        HostScanEngine, as_records, estimate_optimal_threshold, gen_ref_ws_cons, scan_rolling_i64_native,
    )
    from kmergma_tpu_torch.models.miner import mine_genome
    from kmergma_tpu_torch.ops.scan import (
        ScanEngine, _first_window_l0, _plan_regions, rolling_kmer_codes, scan_window_distances,
    )
    from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps, fused_record_bitmaps_plain
    from kmergma_tpu_torch.ops.scan_kernels import (
        _match_counts_plain, match_counts, scan_window_distances_kernel,
    )

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
        fused_record_bitmaps.launches = 0
        match_counts.launches = 0
        times = []
        for i in range(4):  # one warm-up, then three timed runs
            sync()
            t0 = time.perf_counter()
            hits = kt.find_genes(str(fasta), REF, verbose=False)[0]
            sync()
            if i:
                times.append(time.perf_counter() - t0)
        launches = {"fused_record_bitmaps": fused_record_bitmaps.launches, "match_counts": match_counts.launches}
        t_med = statistics.median(times)
        print(
            f"find_genes {total_bp} bp ({n_contigs} contigs): median of 3 {t_med:.3f} s "
            f"= {total_bp / t_med / 1e6:.2f} Mbp/s (runs {', '.join(f'{x:.3f}' for x in times)} s), "
            f"{len(hits)} hits [{label}]"
        )
        t0 = time.perf_counter()
        oracle_res = mine_genome(
            str(fasta), profile, thr=thr,
            engine=HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=r),
        )
        print(f"int64 host oracle (HostScanEngine): {time.perf_counter() - t0:.3f} s, {len(oracle_res.hits)} hits [{label}]")
        stage_breakdown(fasta, profile, thr, t_med, sync, on_card, label)
    require(len(hits) > 0, "no hits on the planted genome")
    require(
        [(h.description, h.seq) for h in hits] == [(h.description, h.seq) for h in oracle_res.hits],
        "find_genes hits differ from the int64 host oracle",
    )
    print(f"hits equal the host oracle's; launch counts over the four runs: {launches}")
    if on_card:
        require(all(v > 0 for v in launches.values()), f"a kernel of the main path never launched: {launches}")

    return {"kernels": [
        {"name": "fused_record_bitmaps", "route": "cuda",
         "source": "kmergma_tpu_torch/csrc/fused_bitmaps.cu",
         "replaces": "kmergma_tpu/ops/scan_fused.py:165",
         "launches": launches["fused_record_bitmaps"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "match_counts", "route": "cuda",
         "source": "kmergma_tpu_torch/csrc/match_counts.cu",
         "replaces": "kmergma_tpu/ops/scan_pallas.py:43",
         "launches": launches["match_counts"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
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
