"""The port's profile-sharded scan (``kmergma_tpu_torch.parallel.tp_lookup``)
against the JAX package and the port's one-device engine, on meshes of
1, 2, 4 and 8 logical CPU shards: the port versions of the TP cases of
tests/test_parallel.py (the sharded lookup at k = 7, the k = 10 engine,
the miner's route) and two gloo processes through
tests/_torch_multihost_worker.py.  On CPU tensors K6 and K2 run their
plain twins.  Integer arithmetic, so the bar is equality."""

import numpy as np
import pytest
import torch

from kmergma_tpu.models.state_machine import replay_single as jax_replay_single
from kmergma_tpu.ops.kmers import kmer_count
from kmergma_tpu.ops.scan_host import HostScanEngine as JaxHostScanEngine
from kmergma_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmergma_tpu.parallel.tp_lookup import TPScanEngine as JaxTPScanEngine
from kmergma_tpu_torch.models import miner as miner_mod
from kmergma_tpu_torch.models.state_machine import replay_single
from kmergma_tpu_torch.ops.reference import RefProfile
from kmergma_tpu_torch.ops.scan import ScanEngine
from kmergma_tpu_torch.parallel.mesh import make_mesh
from kmergma_tpu_torch.parallel.tp_lookup import TPScanEngine, shard_profile, tp_profile_lookup, tp_sq_norm
from kmergma_tpu_torch.utils.fasta import FastaRecord

from ._torch_multihost_worker import run_workers
from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _hits(hits) -> list:
    return [(h.cmi, h.dist, h.start, h.stop) for h in hits]


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_tp_profile_lookup_matches_replicated(n_dev):
    """g = S[K] through the sharded lookup, and ||S||^2 from the shards,
    at k = 7 (16,384 bins, 2,048 a shard on 8)."""
    rng = np.random.default_rng(8)
    k = 7
    s = rng.integers(0, 50, 4**k).astype(np.int32)
    kcodes = rng.integers(0, 4**k, 100_000).astype(np.int32)
    mesh = make_mesh(n_dev, device="cpu")
    shards = shard_profile(s, mesh)
    assert [t.shape[0] for t in shards] == [4**k // n_dev] * n_dev
    got = tp_profile_lookup(torch.from_numpy(kcodes), shards, mesh=mesh)
    assert got.dtype == torch.int32 and got.tolist() == s[kcodes].tolist()
    assert int(tp_sq_norm(shards, mesh)) == int((s.astype(np.int64) ** 2).sum())


def test_shard_profile_pads_to_the_axis():
    """A bin count that does not divide: zeros past the table, as the JAX
    ``shard_profile``."""
    s = np.arange(1, 65, dtype=np.int32)  # k = 3
    shards = shard_profile(s, make_mesh(3, device="cpu"))
    assert [t.tolist() for t in shards] == [list(range(1, 23)), list(range(23, 45)), list(range(45, 65)) + [0, 0]]
    kc = torch.arange(64, dtype=torch.int32).view(8, 8)
    assert torch.equal(tp_profile_lookup(kc, shards, mesh=make_mesh(3, device="cpu")), torch.from_numpy(s).view(8, 8))


@pytest.fixture(scope="module")
def k10_case():
    """tests/test_parallel.py's k = 10 case (ws 1200, r 3, seed 10), and
    the same background with two of the references planted (real hits)."""
    rng = np.random.default_rng(10)
    k, ws, r = 10, 1200, 3
    n = 9000
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[4000 : 4000 + ws] = rng.integers(0, 4, ws, dtype=np.int8)
    planted = codes.copy()
    planted[1000 : 1000 + ws] = refs[0]
    planted[6500 : 6500 + ws] = refs[2]
    host = JaxHostScanEngine(s, k=k, ws=ws, r=r)
    records = [(codes, 120.0), (planted, 70.0)]
    want = []
    for record, thr in records:
        d0, stream, _ = host.record_stream(record, thr)
        want.append((d0, _hits(jax_replay_single(stream, d0, thr, k, ws, n, 50))))
    return {"s": s, "k": k, "ws": ws, "r": r, "n": n, "records": records, "host": want}


@pytest.mark.parametrize("depth", [16, None], ids=["bound", "exact"])
def test_tp_engine_k10_matches_jax(k10_case, depth):
    """The JAX TPScanEngine on the 8-device CPU mesh gives the JAX host
    engine's dist0 and replayed hits; so does the port's TPScanEngine over
    1 and 4 logical shards, whose streams equal the port's one-device
    ScanEngine's, and whose collect_dists equal its distances."""
    c = k10_case
    k, ws, r, n = c["k"], c["ws"], c["r"], c["n"]
    jtp = JaxTPScanEngine(c["s"], k=k, ws=ws, r=r, mesh=jax_make_mesh(8), chunk_windows=4096, bound_depth=depth)
    one = ScanEngine(c["s"], k=k, ws=ws, r=r, device="cpu", bound_depth=depth)
    tps = [TPScanEngine(c["s"], k=k, ws=ws, r=r, mesh=make_mesh(nd, device="cpu"), chunk_windows=4096, bound_depth=depth)
           for nd in (1, 4)]
    assert [tp.shard_bytes for tp in tps] == [4 * 4**k, 4**k] and tps[0].s_dev is None
    n_hits = 0
    for (record, thr), (d0_h, hits_h) in zip(c["records"], c["host"]):
        d0_j, stream_j, _ = jtp.record_stream(record, thr)
        assert (d0_j, _hits(jax_replay_single(stream_j, d0_j, thr, k, ws, n, 50))) == (d0_h, hits_h)
        want = one.record_stream(record, thr)
        for tp in tps:
            d0, stream, _ = tp.record_stream(record, thr)
            assert (d0, stream) == want[:2] and len(stream) > 0
            assert _hits(replay_single(stream, d0, thr, k, ws, n, 50)) == hits_h and d0 == d0_h
        n_hits += len(hits_h)
        wd = one.record_stream(record, thr, collect_dists=True)
        gd = tps[1].record_stream(record, thr, collect_dists=True)
        assert gd[:2] == wd[:2] and np.array_equal(gd[2], wd[2])
    assert n_hits >= 2


def test_tp_bitmap_spans_cover_the_record(k10_case):
    """Short spans (chunk_windows 1024: 8 spans, each seeding its own
    first-window bound) and one span give the same streams."""
    c = k10_case
    record, thr = c["records"][1]
    one = TPScanEngine(c["s"], k=c["k"], ws=c["ws"], r=c["r"], mesh=make_mesh(2, device="cpu"))
    many = TPScanEngine(c["s"], k=c["k"], ws=c["ws"], r=c["r"], mesh=make_mesh(2, device="cpu"), chunk_windows=1024)
    nw = record.shape[0] - c["ws"] + 1
    assert one._spans(nw) == (8192, 1) and many._spans(nw) == (1024, 8)
    assert many.record_stream(record, thr) == one.record_stream(record, thr)


def _big_k_profile(k: int, ws: int = 600) -> RefProfile:
    rng = np.random.default_rng(0)
    s = kmer_count(rng.integers(0, 4, ws, dtype=np.int8), k).astype(np.int64)
    return RefProfile(mean_kfv=s.astype(np.float64), sum_kfv=s, n_records=1, windowsize=ws, consensus="A" * ws, k=k)


def test_mine_genome_routes_big_k_to_tp(monkeypatch):
    """The miner's engine: TPScanEngine on the process group's mesh for
    4^k > 2^18 when this process joined a group of more than one rank
    through initialize_distributed, or over every card, the current one
    first, for device "cuda" on a host with several; else the one-device
    engine (a group made for other work, and a named card, keep it).  The
    scan's hits are the one-device engine's either way."""
    import torch.distributed as dist

    from kmergma_tpu_torch.parallel import mesh as mesh_mod

    seen = []

    class Spy(TPScanEngine):
        def __init__(self, *a, **kw):
            seen.append(kw["mesh"])
            super().__init__(*a, **kw)

    rng = np.random.default_rng(0)
    rec = FastaRecord("contig", bytes(b"ACGT"[c] for c in rng.integers(0, 4, 3000)))
    prof = _big_k_profile(10)
    want = miner_mod.mine_genome([rec], prof, thr=200.0, do_align=False, device="cpu")
    assert not seen and type(miner_mod._default_engine(prof, "cpu")) is ScanEngine
    monkeypatch.setattr(miner_mod, "TPScanEngine", Spy)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    # a group this package did not make (data-parallel ranks): no TP
    assert type(miner_mod._default_engine(prof, "cpu")) is ScanEngine and not seen
    monkeypatch.setattr(mesh_mod, "_JOINED", True)
    mesh = make_mesh(2, device="cpu")
    monkeypatch.setattr(miner_mod, "make_mesh", lambda device: mesh)
    res = miner_mod.mine_genome([rec], prof, thr=200.0, do_align=False, device="cpu")
    assert seen == [mesh], "big-k scan did not route through TPScanEngine"
    assert res.stats.records_scanned == 1 and [h.description for h in res.hits] == [h.description for h in want.hits]
    assert type(miner_mod._default_engine(_big_k_profile(9), "cpu")) is ScanEngine  # 4^9 = 2^18 bins: not big
    # one process on a host with four cards, the current one cuda:2
    monkeypatch.setattr(mesh_mod, "_JOINED", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(miner_mod, "make_mesh", lambda devices: devices)
    assert miner_mod._tp_mesh(10, "cuda") == [torch.device("cuda", i) for i in (2, 3, 0, 1)]
    assert miner_mod._tp_mesh(10, "cuda:1") is None and miner_mod._tp_mesh(9, "cuda") is None


def test_two_process_tp_scan():
    """Two processes joined by gloo, two CPU shards of the table each: the
    TP streams equal one device's in both, and the miner routes a k = 10
    profile to TPScanEngine on its own (tests/_torch_multihost_worker.py)."""
    run_workers("cpu", mode="tp")
