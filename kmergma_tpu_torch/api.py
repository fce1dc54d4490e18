"""User-facing API on the PyTorch scan (counterpart of ``kmergma_tpu.api``):
``find_genes``, ``find_genes_cluster_mode``, ``strobemer_find_genes`` and
``write_results``.

Kwarg names, defaults, validation, warning texts and output ordering are
those of the JAX package: the return value is a list whose first element
is the hit-record list, with hit loci, alignments and distances appended
in that order when requested.  Each search runs on ``device``: the card
(``"cuda"``, the default; raises without CUDA) unless the caller asks for
the CPU (``device="cpu"``).  ``devices=N`` (single profile and cluster
mode) shards the scan over the first N cards, as the JAX package's does
over its first N devices.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import warnings
from typing import Iterable

import numpy as np
import torch

from .models.miner import mine_genome
from .ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from .ops.scan import resolve_device
from .ops.thresholds import estimate_optimal_threshold, estimate_optimal_thresholds
from .ops.thresholds import last_counters as estimate_counters
from .utils import trace
from .utils.fasta import FastaRecord, write_fasta

logger = logging.getLogger("kmergma_tpu_torch")


def _mesh_or_device(devices: int | None, device):
    """(mesh, device): with ``devices`` the mesh of the first ``devices``
    cards (``parallel.mesh.make_mesh``; raises when fewer are present, and
    on ``device="cpu"`` gives that many logical shards of the CPU) and its
    first device; else (None, the resolved ``device``)."""
    if devices is None:
        return None, resolve_device(device)
    from .parallel.mesh import make_mesh

    mesh = make_mesh(devices, device=device)
    return mesh, mesh.first


def _warn_helper(k: int, do_return_dists: bool) -> None:
    if k < 5:
        warnings.warn(f"Such a low k value of {k} likely won't yield the most accurate results")
    if do_return_dists:
        warnings.warn("Setting do_return_dists to true may be very memory intensive")


@trace.api_call
def find_genes(
    genome_path: str,
    ref_path: str,
    k: int = 6,
    kmer_dist_thr: float = 0,
    buffer: int = 50,
    do_align: bool = True,
    gap_open_score: int = -69,
    gap_extend_score: int = -1,
    do_return_dists: bool = False,
    do_return_hit_loci: bool = False,
    do_return_align: bool = False,
    verbose: bool = True,
    kmer_dist_threshold_buffer: float = 8.0,
    devices: int | None = None,
    checkpoint_path: str | None = None,
    *,
    device: "str | torch.device" = "cuda",
) -> list:
    """Single-profile homology search on ``device`` (the card unless the
    caller asks for the CPU).

    Returns ``[hits]`` plus, in priority order when requested, hit loci,
    alignments and per-window distances.  ``checkpoint_path`` enables
    per-record checkpoint/resume (utils/checkpoint.py; a file written by
    either package resumes in the other).  ``devices=N`` shards the scan
    over the first N cards (``parallel.sharded_scan.ShardedScanEngine``)
    and raises when fewer are present."""
    mesh, device = _mesh_or_device(devices, device)
    if verbose:
        logger.info("pre-processing references and parameters...")
    _warn_helper(k, do_return_dists)

    with trace.span("prep") as sp:
        profile = gen_ref_ws_cons(ref_path, k)
        if k >= profile.windowsize:
            raise ValueError(
                f"the average reference sequence length {profile.windowsize} exceeds/is equal to "
                f"the chosen kmer length {k}. please reduce k. "
            )

        estimated = estimate_optimal_threshold(
            profile.mean_kfv, profile.windowsize, buffer=kmer_dist_threshold_buffer
        )
        sp.add(profiles=1, **estimate_counters)
    if kmer_dist_thr == 0:
        kmer_dist_thr = estimated
    elif kmer_dist_thr < estimated:
        warnings.warn(
            f"The kmer distance threshold {kmer_dist_thr} for k = {k} is likely too high, "
            "and can result in many false positives"
        )

    if verbose:
        logger.info("initializing iteration...")
    engine = None
    if mesh is not None:
        from .parallel.sharded_scan import ShardedScanEngine

        engine = ShardedScanEngine(profile.sum_kfv, k=k, ws=profile.windowsize, r=profile.n_records, mesh=mesh)
    res = mine_genome(
        genome_path,
        profile,
        thr=kmer_dist_thr,
        buff=buffer,
        do_align=do_align,
        gap_open=gap_open_score,
        gap_extend=gap_extend_score,
        do_return_dists=do_return_dists,
        do_return_align=do_return_align,
        get_hit_loci=do_return_hit_loci,
        engine=engine,
        checkpoint_path=checkpoint_path,
        device=device,
    )

    return _outputs(res, do_return_hit_loci, do_return_align, do_return_dists, verbose)


@trace.api_call
def find_genes_cluster_mode(
    genome_path: str,
    ref_path: str,
    cluster_cutoffs: list | None = None,
    k: int = 6,
    kmer_dist_thrs: "list | np.ndarray | None" = None,
    buffer: int = 100,
    do_align: bool = True,
    gap_open_score: int = -200,
    gap_extend_score: int = -1,
    do_return_dists: bool = False,
    do_return_hit_loci: bool = False,
    do_return_align: bool = False,
    verbose: bool = True,
    kmer_dist_threshold_buffer: float = 7.0,
    devices: int | None = None,
    checkpoint_path: str | None = None,
    *,
    device: "str | torch.device" = "cuda",
) -> list:
    """Cluster-mode (multi-profile) homology search on ``device`` (the card
    unless the caller asks for the CPU): the reference set is clustered by
    distance to its mean profile and every cluster's profile scans the
    genome in one pass per record.

    Returns ``[hits]`` plus, in priority order when requested, hit loci,
    alignments and per-cluster per-window distances.  ``checkpoint_path``
    enables per-record checkpoint/resume.  ``devices=N`` shards the scan
    over the first N cards (``parallel.sharded_scan.
    ShardedClusterScanEngine``) and raises when fewer are present."""
    from .models.omn_miner import mine_genome_clusters

    mesh, device = _mesh_or_device(devices, device)
    if cluster_cutoffs is None:
        cluster_cutoffs = [7, 12, 20, 25]
    if verbose:
        logger.info("pre-processing references and parameters...")
    _warn_helper(k, do_return_dists)

    with trace.span("prep") as sp:
        clusters = eliminate_null_params(cluster_ref_api(ref_path, k, cutoffs=cluster_cutoffs))
        if k >= min(clusters.windowsizes):
            raise ValueError(
                "some/all of the average reference sequence lengths exceeds/is equal to "
                f"the chosen kmer length {k}. please reduce k. "
            )

        estimated = estimate_optimal_thresholds(
            clusters.kfvs, clusters.windowsizes, buffer=kmer_dist_threshold_buffer
        )
        sp.add(profiles=len(clusters.profiles), **estimate_counters)
    if kmer_dist_thrs is None or (len(kmer_dist_thrs) and kmer_dist_thrs[0] == 0):
        kmer_dist_thrs = estimated
    else:
        too_high = [
            (i + 1, num) for i, num in enumerate(kmer_dist_thrs) if num > estimated[i]
        ]
        if too_high:
            inds = ", ".join(str(i) for i, _ in too_high)
            warnings.warn(
                f"The kmer distance thresholds {list(kmer_dist_thrs)} at index/indicies {inds} "
                f"for k = {k} is potentially too high, and may result in more false positives."
            )

    if verbose:
        logger.info("initializing iteration...")
    engine = None
    if mesh is not None:
        from .parallel.sharded_scan import ShardedClusterScanEngine

        engine = ShardedClusterScanEngine(clusters.profiles, k=k, mesh=mesh)
    res = mine_genome_clusters(
        genome_path,
        clusters.profiles,
        thr_vec=list(map(float, kmer_dist_thrs)),
        buff=buffer,
        do_align=do_align,
        gap_open=gap_open_score,
        gap_extend=gap_extend_score,
        do_return_dists=do_return_dists,
        do_return_align=do_return_align,
        get_hit_loci=do_return_hit_loci,
        engine=engine,
        checkpoint_path=checkpoint_path,
        device=device,
    )
    return _outputs(res, do_return_hit_loci, do_return_align, do_return_dists, verbose)


@trace.api_call
def strobemer_find_genes(
    genome_path: str,
    ref_path: str,
    s: int = 2,
    w_min: int = 3,
    w_max: int = 5,
    q: int = 5,
    kmer_dist_thr: float = 30,
    buffer: int = 50,
    do_align: bool = True,
    align_score_thr: int = 0,
    do_return_dists: bool = False,
    do_return_hit_loci: bool = False,
    do_return_align: bool = False,
    verbose: bool = True,
    checkpoint_path: str | None = None,
    *,
    device: "str | torch.device" = "cuda",
) -> list:
    """Randstrobe-based homology search on ``device`` (the card unless the
    caller asks for the CPU); ref StrobemerGMA/StrobeGenomeMiner.jl:119-158.
    No threshold estimate, as in the reference.

    Returns ``[hits]`` plus, in priority order when requested, hit loci,
    alignments and per-window distances.  ``checkpoint_path`` enables
    per-record checkpoint/resume."""
    from .models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome

    device = resolve_device(device)
    with trace.span("prep") as sp:
        profile = gen_strobe_ref_ws_cons(ref_path, s=s, w_min=w_min, w_max=w_max, q=q)
        sp.add(profiles=1)
    if verbose:
        logger.info("initializing iteration...")
    res = strobe_mine_genome(
        genome_path,
        profile,
        thr=kmer_dist_thr,
        buff=buffer,
        do_align=do_align,
        score_threshold=align_score_thr,
        do_return_dists=do_return_dists,
        do_return_align=do_return_align,
        get_hit_loci=do_return_hit_loci,
        checkpoint_path=checkpoint_path,
        device=device,
    )
    return _outputs(res, do_return_hit_loci, do_return_align, do_return_dists, verbose)


def _outputs(res, do_return_hit_loci: bool, do_return_align: bool, do_return_dists: bool, verbose: bool) -> list:
    """[hits] plus hit loci, alignments and distances, in that order when
    requested; logs the scan stats when ``verbose``, and hands them to the
    ``call`` span when tracing (utils/trace.py)."""
    if trace.enabled():
        trace.add_to_call(**dataclasses.asdict(res.stats))
    out: list = [res.hits]
    if do_return_hit_loci:
        out.append(res.hit_loci)
    if do_return_align:
        out.append(res.alignments)
    if do_return_dists:
        out.append(res.dists)
    if verbose:
        payload = dataclasses.asdict(res.stats)
        payload["mbp_per_second"] = round(res.stats.mbp_per_second, 2)
        logger.info("scan stats: %s", json.dumps(payload))
        logger.info("genome mining completed successfully")
    return out


def write_results(hits: Iterable[FastaRecord], file_path: str, width: int = 95) -> None:
    """Append hit records to a fasta file."""
    write_fasta(hits, file_path, width=width, append=True)
    logger.info("writing complete")
