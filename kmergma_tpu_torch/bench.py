"""The port's throughput harness on one card (counterpart of the root
``bench.py``), and K7, the synthetic genome made on the device.

    python -m kmergma_tpu_torch.bench

Prints ONE JSON line with the keys of the JAX harness: ``metric``,
``value``, ``unit``, ``vs_baseline`` (the headline single-profile scan
against the reference's ~40 Mbp/s), ``hit_dense_mbps``, ``hit_dense_hits``,
``align_s``, ``align_host_s``, ``hit_dense_aligned_mbps``,
``aligned_ingest_mbps``, ``cluster_mbps``, ``cluster_m``,
``cluster_vs_baseline``, ``k10_mbps``, ``strobe_mbps``, ``strobe_hits``,
``genome3g_s``, ``genome3g_mbps`` and ``genome3g_vs_ref_80s``; the values
are not rounded.  Stderr carries the card's name and power limit and each
row's minimum and median over its repeats.

The rows, sizes, seeds, thresholds and order are the JAX harness's: a
512 Mbp random genome (seed 42, threshold 30); a 64 Mbp hit-dense genome
(seed 7, the Alp_V genes planted every 500 kb) scanned and replayed, then
aligned (the NumPy batch and the production router), once end to end and
once streamed from host codes through ``mine_genome``; cluster mode with
m = 6 on the dense genome; k = 10 on 64 Mbp (seed 17, threshold 8); the
strobemer miner on 64 Mbp (seed 3) through ``genome_dev=`` and
``engine_cache=``; and 3.2 Gbp as 6 x 512 Mbp records (seeds 11-16, genes
every 25 Mbp).  Every genome is made on the card by K7 and no byte of it
crosses the link; the timed loops start from the resident codes.

Env knobs: BENCH_MBP, BENCH_DENSE_MBP, BENCH_SKIP_EXTRAS=1 (headline
only), BENCH_SKIP_3G=1 / BENCH_3G_MBP / BENCH_3G_REC_MBP,
BENCH_SKIP_STROBE=1 / BENCH_STROBE_MBP, BENCH_SKIP_K10=1 / BENCH_K10_MBP,
BENCH_DEPTH (the pair depth of the single-profile engines), BENCH_REF (the
reference set; by default the Alp_V set in the checkout's ``tests/data``,
so without it the harness runs from a source checkout only).

Source note (K7).  ``hash_genome`` launches ``csrc/hash_genome.cu``, which
replaces ``bench.py::_pallas_hash_genome``: a splitmix hash of the uint32
position as 2-bit codes, bound by the one byte it writes per code (0.153 ms
for 512 Mbp at 3.35 TB/s).  Each thread writes 16 codes with one 16-byte
store; a grid-stride loop covers any length.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .models.miner import mine_genome
from .models.state_machine import OmnHitEvent, replay_omn, replay_single
from .models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome
from .ops.align import align_hits_batch, semiglobal_align_batch
from .ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from .ops.scan import ScanEngine, resolve_device
from .ops.scan_cluster import ClusterScanEngine
from .utils.fasta import FastaRecord, as_records

#: the default reference set: the Alp_V set of a source checkout
REF_PATH = Path(__file__).resolve().parent.parent / "tests" / "data" / "Alp_V_ref.fasta"
#: the keys of the JSON line, the JAX harness's, in its order
KEYS = (
    "metric", "value", "unit", "vs_baseline", "hit_dense_mbps", "hit_dense_hits", "align_s", "align_host_s",
    "hit_dense_aligned_mbps", "aligned_ingest_mbps", "cluster_mbps", "cluster_m", "cluster_vs_baseline", "k10_mbps",
    "strobe_mbps", "strobe_hits", "genome3g_s", "genome3g_mbps", "genome3g_vs_ref_80s",
)

_U32 = 0xFFFFFFFF
#: codes per piece of the CPU path, bounding its int64 temporaries
_CPU_PIECE = 1 << 22
_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): c is split in 16-bit
    halves, so no product reaches 2^49 (x * c itself overflows int64)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def hash_genome_plain(n: int, seed: int, device, start: int = 0, piece: int | None = None) -> torch.Tensor:
    """The plain PyTorch twin of K7: the hashed codes of positions
    [start, start + n) as int8[n], in int64 masked to 32 bits after each
    step; positions wrap at 2^32 and the seed is taken as uint32.  With
    ``piece``, the codes are made ``piece`` at a time, which bounds the
    int64 temporaries (about 24 bytes per code) at that many codes."""
    if piece is not None and n > piece:
        out = torch.empty(n, dtype=torch.int8, device=device)
        for s in range(0, n, piece):
            out[s : s + piece] = hash_genome_plain(min(piece, n - s), seed, device, start=start + s)
        return out
    pos = torch.arange(start, start + n, dtype=torch.int64, device=device) & _U32
    x = (_mul32(pos, 0x9E3779B9) + (seed & _U32)) & _U32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return ((x >> 7) & 3).to(torch.int8)


def hash_genome(n: int, seed: int, device) -> torch.Tensor:
    """int8[n] hashed 2-bit codes of positions 0..n-1 on ``device``:
    launches K7 on a CUDA device, runs the plain twin (in pieces) on the
    CPU; any other device raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return hash_genome_plain(n, seed, device, piece=_CPU_PIECE)
    if device.type != "cuda":
        raise ValueError(f"hash_genome: unsupported device {device}")
    from ._kernels import check, load

    lib = load()
    out = torch.empty(n, dtype=torch.int8, device=device)
    if n == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("hash_genome: the output must be 16-byte aligned")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(lib.kmg_hash_genome(out.data_ptr(), n, seed & _U32, stream), "hash_genome")
    hash_genome.launches += 1
    return out


#: K7 launches since the count was last set to 0
hash_genome.launches = 0


def _device_random_genome(n_bp: int, seed: int, device) -> torch.Tensor:
    """The harness's synthetic genome: int8[n_bp] hashed codes made on
    ``device`` (the card unless the caller asks for the CPU); the engines
    pad it there themselves."""
    return hash_genome(n_bp, seed, resolve_device(device))


def _plant_positions(ref_records, n_bp: int, spacing: int) -> tuple[range, int]:
    """(start of each planted gene, gene length): every ``spacing`` bp from
    ``spacing // 2``, genes trimmed to the set's shortest."""
    glen = min(len(r) for r in ref_records)
    if spacing < glen:
        raise ValueError(f"planting spacing {spacing} is below the gene length {glen}")
    return range(spacing // 2, n_bp - glen - 100, spacing), glen


def _plant_genes_device(codes: torch.Tensor, ref_records, n_bp: int, spacing: int) -> tuple[torch.Tensor, int]:
    """Write the reference genes, trimmed to the set's shortest, at
    ``_plant_positions``, cycling through the set, into ``codes`` in place
    (one host-to-device copy of the patch, ~36 KB at 64 Mbp).  Returns
    (codes, number planted)."""
    positions, glen = _plant_positions(ref_records, n_bp, spacing)
    if len(positions) == 0:
        return codes, 0
    genes = np.stack([r.codes[:glen] for r in ref_records])
    patch = torch.from_numpy(genes[np.arange(len(positions)) % len(ref_records)]).to(codes.device)
    starts = torch.arange(positions.start, positions.stop, positions.step, device=codes.device)
    codes[starts[:, None] + torch.arange(glen, device=codes.device)[None, :]] = patch
    return codes, len(positions)


def _repeat(fn, repeats: int, sync) -> list[float]:
    """Host wall in seconds of ``repeats`` calls, each ended by a device
    synchronise."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return times


def _spread(times: list[float]) -> str:
    return f"min {min(times):.4f} s, median {statistics.median(times):.4f} s of {len(times)}"


@contextlib.contextmanager
def _env_set(name: str, value: str):
    """``os.environ[name] = value`` for the block; the caller's value, or
    its absence, comes back after."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _note(msg: str) -> None:
    # printed at once: a crash in a later row must not lose earlier ones
    print(msg, file=sys.stderr, flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"bench: {what}")


def run(
    device="cuda",
    *,
    n_mbp: float = 512.0,
    dense_mbp: float = 64.0,
    skip_extras: bool = False,
    k10_mbp: float = 64.0,
    skip_k10: bool = False,
    strobe_mbp: float = 64.0,
    skip_strobe: bool = False,
    g3_mbp: float = 3200.0,
    g3_rec_mbp: float | None = None,
    skip_3g: bool = False,
    bound_depth: int | None = None,
    ref_path: "str | Path" = REF_PATH,
    artefacts: dict | None = None,
    note=_note,
) -> dict:
    """Every row of the harness on ``device`` (the card unless the caller
    asks for the CPU); returns the result dict that ``main`` prints.

    ``g3_rec_mbp`` is the 3.2 Gbp row's record size (the headline's by
    default); ``bound_depth`` the pair depth of the single-profile engines
    (their default without it); ``ref_path`` the reference set.
    ``artefacts``, where given, receives what a checker needs to hold the
    rows against oracles: the headline's and the k = 10 row's (dist0,
    stream), the dense genome's host codes and hits, the cluster engine
    with its profiles, thresholds and last streams, the strobe row's record
    and hits, and the 3.2 Gbp row's resident records (so they outlive the
    call), planted positions, each record's (dist0, stream, hits) and the
    per-repeat counts."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    keep = artefacts if artefacts is not None else {}
    n_bp = int(n_mbp * 1e6)
    dense_bp = int(dense_mbp * 1e6)
    ref_path = str(ref_path)
    profile = gen_ref_ws_cons(ref_path, 6)
    k, ws = profile.k, profile.windowsize
    thr = 30.0
    eng_kwargs = {} if bound_depth is None else {"bound_depth": bound_depth}
    engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records, device=dev, **eng_kwargs)

    # ---- headline: random genome, the production single-profile pass ----
    t0 = time.perf_counter()
    genome = _device_random_genome(n_bp, 42, dev)
    sync()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.record_stream(genome, thr)  # warm-up
    first = time.perf_counter() - t0
    dist0 = stream = None

    def run_random():
        nonlocal dist0, stream
        dist0, stream, _ = engine.record_stream(genome, thr)

    times = _repeat(run_random, 3, sync)
    hits = replay_single(stream, dist0, thr, k, ws, n_bp, 50)
    keep["random"] = {"thr": thr, "dist0": dist0, "stream": stream, "hits": hits}
    mbps = n_bp / min(times) / 1e6
    del genome
    result = {"metric": "findGenes_scan_throughput", "value": mbps, "unit": "Mbp/s", "vs_baseline": mbps / 40.0}
    note(
        f"# random: {n_mbp:g} Mbp scan {_spread(times)} ({mbps:.2f} Mbp/s at the min); device genome gen "
        f"{gen_s:.4f} s; first pass {first:.4f} s; {len(stream)} candidates, {len(hits)} hits"
    )
    if skip_extras:
        return result

    # ---- hit-dense genome: region recompute + replay in the loop ----------
    refs = as_records(ref_path)
    dgenome, planted = _plant_genes_device(_device_random_genome(dense_bp, 7, dev), refs, dense_bp, 500_000)
    sync()
    engine.record_stream(dgenome, thr)  # warm-up
    dhits: list = []

    def run_dense():
        nonlocal dist0, stream, dhits
        dist0, stream, _ = engine.record_stream(dgenome, thr)
        dhits = replay_single(stream, dist0, thr, k, ws, dense_bp, 50)

    dtimes = _repeat(run_dense, 6, sync)
    dmbps = dense_bp / min(dtimes) / 1e6
    result["hit_dense_mbps"] = dmbps
    result["hit_dense_hits"] = len(dhits)
    note(
        f"# hit-dense: {dense_mbp:g} Mbp with {planted} planted V genes: {_spread(dtimes)} "
        f"({dmbps:.2f} Mbp/s at the min); {len(stream)} candidates -> {len(dhits)} hits"
    )

    # ---- alignment at hit-dense scale (every loop above excludes it) -------
    t0 = time.perf_counter()
    gcodes_d = dgenome.cpu().numpy()
    gseq = _LETTERS[gcodes_d].tobytes()
    gfetch_s = time.perf_counter() - t0
    windows = [gseq[h.start - 1 : h.stop].decode("ascii").upper() for h in dhits]

    def run_align_host():
        # the NumPy wavefront batch, to which the native DP is pinned
        with _env_set("KMERGMA_ALIGN_NATIVE", "0"):
            return semiglobal_align_batch(profile.consensus_ws, windows)

    def run_align():  # the production router (A1 on a card for 16 windows or more)
        return align_hits_batch(profile.consensus_ws, windows, device=dev)

    host_aln = run_align_host()
    ahost = _repeat(run_align_host, 3, sync)
    prod_aln = run_align()  # warm-up
    atimes = _repeat(run_align, 3, sync)
    _check([a.cigar for a in prod_aln] == [a.cigar for a in host_aln], "the production aligner's cigars differ from the NumPy batch's")
    result["align_s"] = min(atimes)
    result["align_host_s"] = min(ahost)

    # the aligned row: ONE timed run of everything between a resident
    # record and its aligned hits (scan, replay, window decode, alignment)
    aligned_hits = None

    def run_aligned_e2e():
        nonlocal aligned_hits
        d0, strm, _ = engine.record_stream(dgenome, thr)
        hh = replay_single(strm, d0, thr, k, ws, dense_bp, 50)
        wins = [gseq[h.start - 1 : h.stop].decode("ascii").upper() for h in hh]
        aligned_hits = align_hits_batch(profile.consensus_ws, wins, device=dev)

    run_aligned_e2e()
    _check([a.cigar for a in aligned_hits] == [a.cigar for a in host_aln], "the aligned row's cigars differ")
    aetimes = _repeat(run_aligned_e2e, 5, sync)
    result["hit_dense_aligned_mbps"] = dense_bp / min(aetimes) / 1e6

    # streamed ingest: mine_genome from host codes (H2D, scan, replay, align)
    drecord = FastaRecord("bench_dense", gseq, _codes=gcodes_d)
    mres = mine_genome([drecord], profile, thr=thr, do_align=True, engine=engine)
    _check(len(mres.hits) == len(dhits), f"mine_genome found {len(mres.hits)} hits, the dense row {len(dhits)}")
    itimes = _repeat(lambda: mine_genome([drecord], profile, thr=thr, do_align=True, engine=engine), 2, sync)
    result["aligned_ingest_mbps"] = dense_bp / min(itimes) / 1e6
    note(
        f"# align: {len(dhits)} hits, production router {_spread(atimes)}; NumPy batch {_spread(ahost)}; "
        f"cigars identical; genome fetch for sequence bytes {gfetch_s:.4f} s, one-time; ONE "
        f"scan+replay+decode+align run {_spread(aetimes)} -> {result['hit_dense_aligned_mbps']:.2f} Mbp/s "
        f"with alignment; streamed mine_genome from host codes {_spread(itimes)} -> "
        f"{result['aligned_ingest_mbps']:.2f} Mbp/s"
    )
    keep["dense"] = {"codes": gcodes_d, "hits": dhits, "thr": thr, "profile": profile}

    # ---- cluster mode: m profiles, one pass per record --------------------
    clusters = eliminate_null_params(cluster_ref_api(ref_path, 6, cutoffs=[7, 12, 20, 25]))
    m = len(clusters.profiles)
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0][:m]
    ceng = ClusterScanEngine(clusters.profiles, k=6, device=dev)
    ceng.record_streams(dgenome, thrs)  # warm-up (K8 on the engine's first K3 record)
    windowsizes = [p.windowsize for p in clusters.profiles]
    pairs: list = []
    n_events = 0

    def run_cluster():
        nonlocal pairs, n_events
        pairs = ceng.record_streams(dgenome, thrs)
        events = []

        def process(ev: OmnHitEvent) -> bool:
            events.append(ev)
            return True

        replay_omn([p[1] for p in pairs], [p[0] for p in pairs], thrs, 6, windowsizes, dense_bp, process)
        n_events = len(events)

    ctimes = _repeat(run_cluster, 5, sync)
    cmbps = dense_bp / min(ctimes) / 1e6
    cluster_baseline = 40.0 / m
    result["cluster_mbps"] = cmbps
    result["cluster_m"] = m
    result["cluster_vs_baseline"] = cmbps / cluster_baseline
    note(
        f"# cluster (m={m}): {dense_mbp:g} Mbp {_spread(ctimes)} ({cmbps:.2f} Mbp/s at the min, "
        f"{cmbps / cluster_baseline:.2f}x the {cluster_baseline:.2f} Mbp/s reference); {n_events} hit events"
    )
    keep["cluster"] = {"engine": ceng, "profiles": clusters.profiles, "thrs": thrs, "pairs": pairs}
    del dgenome

    # ---- big k on one card: k = 10 (4^10 bins) ----------------------------
    if not skip_k10:
        k10_bp = int(k10_mbp * 1e6)
        p10 = gen_ref_ws_cons(ref_path, 10)
        e10 = ScanEngine(p10.sum_kfv, k=10, ws=p10.windowsize, r=p10.n_records, device=dev, **eng_kwargs)
        g10 = _device_random_genome(k10_bp, 17, dev)
        # k = 10 random-window distances sit near 14; a threshold below
        # that baseline keeps the exact recompute to the windows that need it
        k10_thr = 8.0
        t0 = time.perf_counter()
        e10.record_stream(g10, k10_thr)  # warm-up
        k10_first = time.perf_counter() - t0
        k10_out = None

        def run_k10():
            nonlocal k10_out
            k10_out = e10.record_stream(g10, k10_thr)

        k10_times = _repeat(run_k10, 3, sync)
        result["k10_mbps"] = k10_bp / min(k10_times) / 1e6
        note(
            f"# k=10: {k10_mbp:g} Mbp on one device {_spread(k10_times)} ({result['k10_mbps']:.2f} Mbp/s at "
            f"the min; first pass {k10_first:.4f} s)"
        )
        keep["k10"] = {"profile": p10, "thr": k10_thr, "dist0": k10_out[0], "stream": k10_out[1]}
        del g10

    # ---- strobemers: the production miner end to end ----------------------
    if not skip_strobe:
        strobe_bp = int(strobe_mbp * 1e6)
        sprof = gen_strobe_ref_ws_cons(ref_path)
        sthr = 30.0
        bgen, _n = _plant_genes_device(_device_random_genome(strobe_bp, 3, dev), refs, strobe_bp, 500_000)
        # one genome fetch outside the loop, so hit records format from the
        # sequence bytes (production reads them from the FASTA)
        t0 = time.perf_counter()
        scodes = bgen.cpu().numpy()
        srec = FastaRecord("bench_strobe", _LETTERS[scodes].tobytes(), _codes=scodes)
        fetch_s = time.perf_counter() - t0
        sres = None
        s_engines: dict = {}

        def run_strobe():
            nonlocal sres
            sres = strobe_mine_genome(
                [srec], sprof, thr=sthr, do_align=False, genome_dev=[bgen], engine_cache=s_engines, device=dev,
            )

        run_strobe()  # warm-up
        stimes = _repeat(run_strobe, 4, sync)
        smbps = strobe_bp / min(stimes) / 1e6
        result["strobe_mbps"] = smbps
        result["strobe_hits"] = len(sres.hits)
        note(
            f"# strobe: {strobe_mbp:g} Mbp strobe_mine_genome (device extraction + span scan + replay + "
            f"hit formatting) {_spread(stimes)} ({smbps:.2f} Mbp/s at the min); {len(sres.hits)} hits; "
            f"one-time genome fetch {fetch_s:.4f} s"
        )
        keep["strobe"] = {"record": srec, "profile": sprof, "thr": sthr, "hits": [(h.description, h.seq) for h in sres.hits]}
        del bgen

    # ---- ~3.2 Gbp as chromosome-scale records (a whole human genome) -------
    if not skip_3g:
        rec_mbp = n_mbp if g3_rec_mbp is None else g3_rec_mbp
        rec_bp = int(rec_mbp * 1e6)
        n_rec = max(1, int(round(g3_mbp / rec_mbp)))
        g3_bp = rec_bp * n_rec
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        gens = [
            _plant_genes_device(_device_random_genome(rec_bp, 11 + i, dev), refs, rec_bp, 25_000_000)[0]
            for i in range(n_rec)
        ]
        positions, glen = _plant_positions(refs, rec_bp, 25_000_000)
        sync()
        engine.record_stream(gens[0], thr)  # warm-up
        counts: list = []
        rec_out: list = []  # (dist0, stream, hits) per record of the last repeat

        def run_3g():
            nonlocal rec_out
            rec_out = []
            for g in gens:
                d0, st, _ = engine.record_stream(g, thr)
                rec_out.append((d0, st, replay_single(st, d0, thr, k, ws, rec_bp, 50)))
            counts.append((sum(len(st) for _d0, st, _h in rec_out), sum(len(h) for _d0, _st, h in rec_out)))

        gtimes = _repeat(run_3g, 2, sync)
        gbest = min(gtimes)
        result["genome3g_s"] = gbest
        result["genome3g_mbps"] = g3_bp / gbest / 1e6
        result["genome3g_vs_ref_80s"] = 80.0 / gbest
        peak = f"; peak device memory {torch.cuda.max_memory_allocated(dev)} bytes" if dev.type == "cuda" else ""
        note(
            f"# 3.2 Gbp: {n_rec} records x {rec_mbp:g} Mbp, {n_rec * len(positions)} planted genes, "
            f"scan+replay {_spread(gtimes)} ({result['genome3g_mbps']:.2f} Mbp/s at the min, "
            f"{80.0 / gbest:.2f}x the reference's ~80 s); per repeat (candidates, hits) {counts}{peak}"
        )
        keep["g3"] = {"genomes": gens, "planted": list(positions), "glen": glen, "records": rec_out, "counts": counts}
        del gens
    return result


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    env = os.environ.get
    n_mbp = float(env("BENCH_MBP", "512"))
    kwargs = dict(
        n_mbp=n_mbp,
        dense_mbp=float(env("BENCH_DENSE_MBP", "64")),
        skip_extras=env("BENCH_SKIP_EXTRAS", "") == "1",
        skip_3g=env("BENCH_SKIP_3G", "") == "1",
        g3_mbp=float(env("BENCH_3G_MBP", "3200")),
        g3_rec_mbp=float(env("BENCH_3G_REC_MBP", str(n_mbp))),
        skip_strobe=env("BENCH_SKIP_STROBE", "") == "1",
        strobe_mbp=float(env("BENCH_STROBE_MBP", "64")),
        skip_k10=env("BENCH_SKIP_K10", "") == "1",
        k10_mbp=float(env("BENCH_K10_MBP", "64")),
    )
    if env("BENCH_DEPTH"):
        kwargs["bound_depth"] = int(env("BENCH_DEPTH"))
    kwargs["ref_path"] = env("BENCH_REF", str(REF_PATH))
    dev = resolve_device("cuda")  # raises without CUDA
    _note(f"# card: {card_label()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run(dev, **kwargs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
