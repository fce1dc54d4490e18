"""The port's sharded scan (``kmergma_tpu_torch.parallel``) against the
one-device engines and the JAX package, on meshes of 1, 2 and 4 logical
CPU shards: the port versions of tests/test_parallel.py (without
``TPScanEngine``), the sharded cases of tests/test_fault_tolerance.py,
tests/test_checkpoint.py's sharded case, the sharded fuzz of
tests/test_conformance_fuzz.py and tests/test_multihost.py (two gloo
processes).  The streams are integer arithmetic, so the bar is equality."""

import json
import os

import numpy as np
import pytest
import torch

import kmergma_tpu_torch as kt
from kmergma_tpu.ops.kmers import kmer_count
from kmergma_tpu.ops.scan import ScanEngine as JaxScanEngine
from kmergma_tpu.ops.scan_cluster import ClusterScanEngine as JaxClusterScanEngine
from kmergma_tpu.ops.scan_host import scan_window_distances_np_i64
from kmergma_tpu_torch.models.miner import mine_genome
from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
from kmergma_tpu_torch.models.state_machine import replay_single
from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from kmergma_tpu_torch.ops.scan import ScanEngine
from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
from kmergma_tpu_torch.parallel.mesh import NotEnoughDevices, make_mesh
from kmergma_tpu_torch.parallel.sharded_scan import ShardedClusterScanEngine, ShardedScanEngine
from kmergma_tpu_torch.utils.checkpoint import ScanCheckpoint
from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

from ._torch_multihost_worker import run_workers
from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from .test_api_golden import REFERENCE_GOLDEN_HITS

CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
GOLDEN_CLUSTER = [
    "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
    "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
    "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
]
GOLDEN_LOCI = [8543, 20425, 221912, 234018, 450875, 467930, 477868]
SHARDS = [1, 2, 4]


def _mesh(n_dev: int):
    return make_mesh(n_dev, device="cpu")


@pytest.fixture(scope="module")
def profile(ref_fasta):
    return gen_ref_ws_cons(ref_fasta, 6)


@pytest.fixture(scope="module")
def clusters(ref_fasta):
    return eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))


def _planted_record(ref_fasta, seed: int, positions, n: int = 120_000) -> FastaRecord:
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].copy()
    refs = as_records(ref_fasta)
    for pos in positions:
        g = refs[pos % len(refs)].seq.upper()
        seq[pos : pos + len(g)] = np.frombuffer(g, dtype=np.uint8)
    return FastaRecord("big", seq.tobytes())


def _same(got, want) -> None:
    assert [(h.description, h.seq) for h in got.hits] == [(h.description, h.seq) for h in want.hits]
    assert got.hit_loci == want.hit_loci


# --- meshes ----------------------------------------------------------------


def test_mesh_shapes():
    m = make_mesh(8, device="cpu")
    assert m.shape == {"clusters": 1, "data": 8} and m.local_data == [torch.device("cpu")] * 8
    m = make_mesh(devices=["cpu"] * 3)
    assert m.shape == {"clusters": 1, "data": 3} and not m.distributed and m.first == torch.device("cpu")


def test_mesh_never_falls_back(monkeypatch):
    """``make_mesh(N)`` on the card takes N cards or raises: without CUDA,
    and with fewer cards than asked for."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(NotEnoughDevices, match="2 CUDA devices requested, 1 present"):
        make_mesh(2)
    with pytest.raises(NotEnoughDevices):
        kt.find_genes_cluster_mode("unused.fasta", "unused.fasta", verbose=False, devices=2)
    assert make_mesh(1).local_data == [torch.device("cuda", 0)]


@pytest.mark.parametrize("local_rank", [None, "2"])
def test_hybrid_mesh_takes_the_process_card(monkeypatch, local_rank):
    """Across processes each process drives its own card by default (its
    ``LOCAL_RANK``, else its rank modulo the cards present), so processes
    on one host never share a card in the NCCL group."""
    import torch.distributed as dist

    from kmergma_tpu_torch.parallel.mesh import make_hybrid_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 5)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    m = make_hybrid_mesh()
    assert m.local_data == [torch.device("cuda", 2 if local_rank else 1)]
    assert m.shape == {"clusters": 1, "data": 8} and m.process_index == 5 and m.distributed
    assert make_hybrid_mesh(device="cpu").local_data == [torch.device("cpu")]


# --- sharded streams equal the one-device engines' -------------------------


@pytest.mark.parametrize("n_dev", SHARDS)
def test_sharded_stream_equals_single_device(n_dev):
    rng = np.random.default_rng(11)
    n, k, ws, r = 40_000, 6, 289, 12
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)
    single = ScanEngine(s, k=k, ws=ws, r=r, device="cpu", chunk_windows=4096)
    thr = float(np.percentile(scan_window_distances_np_i64(codes, s, k, ws, r) / single.scale, 4))
    want = single.record_stream(codes, thr)
    jax_engine = JaxScanEngine(s, k=k, ws=ws, r=r, chunk_windows=4096)
    jax_engine.full_fetch_windows = 0
    assert jax_engine.record_stream(codes, thr)[:2] == want[:2]
    sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=_mesh(n_dev), chunk_windows=2048)
    got = sharded.record_stream(codes, thr)
    assert got[:2] == want[:2] and len(want[1]) > 4
    assert replay_single(got[1], got[0], thr, k, ws, n, buff=10) == replay_single(want[1], want[0], thr, k, ws, n, buff=10)


@pytest.mark.parametrize("kind", ["single", "cluster"])
def test_every_shard_works_at_the_default_chunk(monkeypatch, clusters, kind):
    """At the default ``chunk_windows`` (2^25, far above the record) the
    one-pass scan still cuts the record into 4 shards of equal rspan-aligned
    span, each scanned on its own, and the streams are the one-device
    engine's: the checkpoint grid's ``chunk`` does not decide the shards."""
    rng = np.random.default_rng(5)
    n, k, ws, r = 40_000, 6, 289, 12
    codes = rng.integers(0, 4, n, dtype=np.int8)
    shards = []
    if kind == "single":
        s = rng.integers(0, 10, 4**k).astype(np.int32)
        single = ScanEngine(s, k=k, ws=ws, r=r, device="cpu")
        thr = float(np.percentile(scan_window_distances_np_i64(codes, s, k, ws, r) / single.scale, 4))
        sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=_mesh(4), device="cpu")
        real = sharded._record_bitmap
        monkeypatch.setattr(sharded, "_record_bitmap", lambda prep, nv, *a, **kw: shards.append(nv) or real(prep, nv, *a, **kw))
        want, got = single.record_stream(codes, thr)[:2], sharded.record_stream(codes, thr)[:2]
        nw = n - ws + 1
    else:
        single = ClusterScanEngine(clusters.profiles, k=6, device="cpu")
        sharded = ShardedClusterScanEngine(clusters.profiles, k=6, mesh=_mesh(4), device="cpu")
        real = sharded._bitmaps
        monkeypatch.setattr(sharded, "_bitmaps", lambda prep, nvs, *a, **kw: shards.append(max(nvs)) or real(prep, nvs, *a, **kw))
        want, got = single.record_streams(codes, CLUSTER_THRS), sharded.record_streams(codes, CLUSTER_THRS)
        nw = n - min(p.windowsize for p in clusters.profiles) + 1
    assert sharded.chunk == 1 << 25 and got == want
    span = -(-(-(-nw // 4)) // 1024) * 1024
    assert shards == [span, span, span, nw - 3 * span], shards


@pytest.mark.parametrize("n_dev", SHARDS)
def test_sharded_miner_golden(test_genome, profile, n_dev):
    engine = ShardedScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records, mesh=_mesh(n_dev),
                               chunk_windows=8192)
    res = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True, engine=engine)
    assert res.hit_loci == GOLDEN_LOCI


@pytest.mark.parametrize("n_dev", [2, 4])
def test_find_genes_devices_golden(mini_genome, ref_fasta, n_dev):
    hits = kt.find_genes(mini_genome, ref_fasta, verbose=False, devices=n_dev, device="cpu")[0]
    assert [h.description for h in hits] == REFERENCE_GOLDEN_HITS
    hits = kt.find_genes_cluster_mode(mini_genome, ref_fasta, kmer_dist_thrs=CLUSTER_THRS, buffer=100, verbose=False,
                                      devices=n_dev, device="cpu")[0]
    assert [h.description for h in hits] == GOLDEN_CLUSTER


@pytest.mark.parametrize("route", ["split", "k3"])
@pytest.mark.parametrize("n_dev", SHARDS)
def test_sharded_cluster_streams_match_serial(mini_genome, clusters, n_dev, route):
    """On the Alp_V locus, each shard on K5's split pass or on K3: the
    streams equal the one-device engine's and the JAX engine's."""
    record = as_records(mini_genome)[0]
    serial = ClusterScanEngine(clusters.profiles, k=6, device="cpu")
    sharded = ShardedClusterScanEngine(clusters.profiles, k=6, mesh=_mesh(n_dev), chunk_windows=4096)
    if route == "k3":
        sharded.fused_min_windows = 1
    want = serial.record_streams(record.codes, CLUSTER_THRS)
    assert sharded.record_streams(record.codes, CLUSTER_THRS) == want
    if n_dev == 1 and route == "split":
        jeng = JaxClusterScanEngine(clusters.profiles, k=6, chunk_windows=1 << 18, use_fused=False)
        jeng.engines[0].full_fetch_windows = 0
        assert jeng.record_streams(record.codes, CLUSTER_THRS) == want


def test_sharded_mixed_depth_streams_match_serial(mini_genome, clusters, ref_fasta):
    """A mixed-depth set (the clusters plus a 20 bp prefix profile): each
    shard takes K4 and K6, and the streams equal the one-device engine's."""
    prefixes = gen_ref_ws_cons([FastaRecord(r.description, r.seq[:20]) for r in as_records(ref_fasta)], 6)
    profiles = [*clusters.profiles, prefixes]
    thrs = [*CLUSTER_THRS, 3.0]
    record = as_records(mini_genome)[0]
    sharded = ShardedClusterScanEngine(profiles, k=6, mesh=_mesh(4), chunk_windows=4096)
    assert not sharded.one_depth
    want = ClusterScanEngine(profiles, k=6, device="cpu").record_streams(record.codes, thrs)
    assert sharded.record_streams(record.codes, thrs) == want


_FUZZ = [(0, 2), (1, 4), (2, 1), (3, 4), (4, 2), (5, 4), (6, 1), (7, 2)]


@pytest.mark.parametrize("seed,n_dev", _FUZZ)
def test_sharded_fuzz_vs_single_device(seed, n_dev):
    """Random profile, windowsize, record and threshold (seeded with numpy,
    as the JAX fuzz): the sharded engine's stream equals the JAX
    one-device engine's."""
    rng = np.random.default_rng(100 + seed)
    k = 6
    ws = int(rng.integers(100, 300))
    r = int(rng.integers(2, 13))
    n = int(rng.integers(25_000, 45_000))
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(1_000, n - ws - 100, 3_000):
        mutant = refs[pos % r].copy()
        idx = rng.integers(0, ws, ws // 6)
        mutant[idx] = rng.integers(0, 4, ws // 6)
        codes[pos : pos + ws] = mutant
    single = JaxScanEngine(s, k=k, ws=ws, r=r, chunk_windows=4096)
    single.full_fetch_windows = 0
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = float(np.percentile(d / single.scale, float(rng.uniform(1.0, 6.0))))
    want = single.record_stream(codes, thr)
    sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=_mesh(n_dev), chunk_windows=2048)
    assert sharded.record_stream(codes, thr)[:2] == want[:2], (seed, n_dev)
    assert len(replay_single(want[1], want[0], thr, k, ws, n, 20)) > 0


# --- checkpoints through the sharded engines -------------------------------


def test_checkpoint_with_sharded_engine(tmp_path, test_genome, profile):
    full = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True, device="cpu")
    ckpt = tmp_path / "sharded.ckpt"
    c = ScanCheckpoint.load_or_create(str(ckpt), f"{test_genome}|k=6|ws={profile.windowsize}|thr=30")
    first = [h for h in full.hits if "JQ684648" in h.description]
    c.record_done(0, 121478, first, full.hit_loci[: len(first)])
    engine = ShardedScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records, mesh=_mesh(4),
                               chunk_windows=8192)
    resumed = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True, engine=engine,
                          checkpoint_path=str(ckpt))
    _same(resumed, full)
    assert resumed.stats.records_scanned == 3


def _kill_on_batch(engine, attr: str, n_batches: int) -> None:
    """Make ``engine``'s segmented pass (``attr``) raise ``KeyboardInterrupt``
    once ``n_batches`` batches are persisted."""
    real = getattr(engine, attr)

    def killer(*args):
        tracker = args[-1]
        orig = tracker.done_segment

        def dying(si, words, fp):
            orig(si, words, fp)
            if si + 1 >= n_batches:
                raise KeyboardInterrupt("killed mid-record")

        tracker.done_segment = dying
        return real(*args)

    setattr(engine, attr, killer)


def _count_calls(engine, attr: str) -> list:
    real, calls = getattr(engine, attr), [0]

    def counted(*a):
        calls[0] += 1
        return real(*a)

    setattr(engine, attr, counted)
    return calls


@pytest.mark.parametrize("kind", ["single", "cluster"])
def test_sharded_mid_record_segment_resume(tmp_path, ref_fasta, profile, clusters, kind):
    """A record of 4 segment batches (4 shards x 4 spans x 2048 windows)
    killed after 2 resumes after batch 2: only the 2 remaining batches go
    through the mesh, the hits and loci are the uninterrupted run's."""
    record = _planted_record(ref_fasta, 7 if kind == "single" else 9, (15_000, 48_000, 76_000, 104_000))
    if kind == "single":
        def fresh():
            return ShardedScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
                                     mesh=_mesh(4), chunk_windows=2048)

        def run(engine, **kw):
            return mine_genome([record], profile, thr=30, engine=engine, get_hit_loci=True, **kw)

        seg_attr, pass_attr = "_segmented_sharded_bitmaps", "_sharded_pass"
    else:
        def fresh():
            return ShardedClusterScanEngine(clusters.profiles, k=6, mesh=_mesh(4), chunk_windows=2048)

        def run(engine, **kw):
            return mine_genome_clusters([record], clusters.profiles, thr_vec=CLUSTER_THRS, engine=engine,
                                        get_hit_loci=True, **kw)

        seg_attr, pass_attr = "_segmented_cluster_bitmaps", "_cluster_pass"
    baseline = run(fresh())
    assert len(baseline.hits) >= 3
    ckpt = str(tmp_path / "shseg.ckpt")
    engine = fresh()
    _kill_on_batch(engine, seg_attr, 2)
    with pytest.raises(KeyboardInterrupt):
        run(engine, checkpoint_path=ckpt)
    data = json.load(open(ckpt))
    assert data["seg_record"] == 0 and data["seg_next"] == 2
    assert data["seg_fingerprint"].startswith("sharded|" if kind == "single" else "shcluster|")
    engine = fresh()
    passes = _count_calls(engine, pass_attr)
    res = run(engine, checkpoint_path=ckpt)
    assert passes[0] == 2
    _same(res, baseline)
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("kind", ["single", "cluster"])
def test_sharded_segmented_stream_equals_unsegmented(tmp_path, mini_genome, profile, clusters, kind):
    record = as_records(mini_genome)[0]
    ckpt = ScanCheckpoint.load_or_create(str(tmp_path / "s.ckpt"), "g")
    if kind == "single":
        engine = ShardedScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records, mesh=_mesh(4),
                                   chunk_windows=1024)
        a = engine.record_stream(record.codes, 30.0)[:2]
        b = engine.record_stream(record.codes, 30.0, seg_tracker=ckpt.segment_tracker(0))[:2]
        assert len(a[1]) > 0
    else:
        engine = ShardedClusterScanEngine(clusters.profiles, k=6, mesh=_mesh(4), chunk_windows=1024)
        a = engine.record_streams(record.codes, CLUSTER_THRS)
        b = engine.record_streams(record.codes, CLUSTER_THRS, seg_tracker=ckpt.segment_tracker(0))
        assert any(len(st) > 0 for _, st in a)
    assert ckpt.seg_next >= 2  # the segmented path ran
    assert b == a


# --- two processes ---------------------------------------------------------


def test_two_process_sharded_scan():
    """Two processes joined by gloo, two CPU shards each: the sharded
    single-profile and cluster streams (one pass and segment batches) are
    bit-identical to one device's in both (tests/_torch_multihost_worker.py)."""
    run_workers("cpu")
