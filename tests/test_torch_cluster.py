"""Cluster mode of the port (kmergma_tpu_torch.ops.scan_cluster,
.ops.scan_cluster_fused, .models.omn_miner, find_genes_cluster_mode)
against the JAX package on the CPU, with the same seeded inputs through
both.  Zero tolerance: the scan is integer arithmetic and the streams are
integer distances divided by the same float64 scale.

On CPU tensors K3, K5 and K8 run their plain twins.  The JAX cluster engine
runs its XLA split pass (no interpret-mode Pallas) with
``full_fetch_windows = 0``, so it assembles the minimal run-reduced streams
that the port always produces."""

import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmergma_tpu_torch as kt
from kmergma_tpu.models.omn_miner import mine_genome_clusters as jax_mine_genome_clusters
from kmergma_tpu.models.state_machine import replay_omn
from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops import scan_cluster as jcluster
from kmergma_tpu.ops.kmers import kmer_count
from kmergma_tpu.ops.reference import RefProfile, cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from kmergma_tpu.ops.scan_host import scan_window_distances_np_i64
from kmergma_tpu.utils.fasta import FastaRecord, as_records
from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops import scan_cluster as tcluster
from kmergma_tpu_torch.ops.scan_cluster_fused import fused_cluster_record_bitmaps, lookup_roundtrip
from kmergma_tpu_torch.ops.scan_kernels import codes_pair_multi

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data"
THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]  # the reference's cluster golden


@pytest.fixture(scope="module")
def clusters(ref_fasta):
    """The Alp_V set at k = 6, cutoffs [7, 12, 20, 25]: six clusters,
    windowsizes [288, 288, 288, 289, 290, 289], three groups."""
    return eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))


def _jax_engine(profiles, k=6):
    eng = jcluster.ClusterScanEngine(profiles, k=k, chunk_windows=1 << 18, use_fused=False)
    eng.engines[0].full_fetch_windows = 0
    return eng


def _port_engine(profiles, k=6, fused=False):
    eng = tcluster.ClusterScanEngine(profiles, k=k, device="cpu")
    if fused:
        eng.fused_min_windows = 1  # K3 on records of any length
    return eng


def _planted_codes(seed, n, plant_at):
    """Random background with Alp_V reference genes planted at ``plant_at``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    genes = [rec.codes for rec in as_records(str(DATA / "Alp_V_ref.fasta"))]
    for i, pos in enumerate(plant_at):
        g = genes[(7 * i + seed) % len(genes)]
        codes[pos : pos + len(g)] = g
    return codes


def _random_profile(rng, k, ws, r):
    s = np.zeros(4**k, dtype=np.int64)
    for _ in range(r):
        s += kmer_count(rng.integers(0, 4, ws, dtype=np.int8), k).astype(np.int64)
    return RefProfile(mean_kfv=s / r, sum_kfv=s, n_records=r, windowsize=ws, consensus="A" * ws, k=k)


# --- K5, K3 and K8 twins against the JAX package -------------------------


@pytest.mark.parametrize("k,ws_tuple,n", [(5, (96, 96, 101, 120), 9_000), (6, (288, 289, 290), 9_000), (6, (288, 289, 290), 5_100)])
def test_k5_twin_matches_jax_pair_ab(k, ws_tuple, n):
    """codes_pair_multi's plain twin: every group's ab equals _pair_ab_xla
    on rolling_kmer_codes_jnp, and the K codes are K; codes past the end
    read as zeros, as the JAX kernel's padding does (n = 5_100)."""
    rng = np.random.default_rng(n + k)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[3_000:3_400] = codes[1_000:1_400]  # repeats, so pairs match
    nt, depth = 5_000, 16
    nkc = nt + max(ws_tuple) - k
    ab, kc = codes_pair_multi(torch.from_numpy(codes), k, ws_tuple, nt, nkc, depth)
    padded = np.zeros(nt + max(ws_tuple) + k, dtype=np.int8)
    padded[: min(n, padded.shape[0])] = codes[: padded.shape[0]]
    K = jscan.rolling_kmer_codes_jnp(jnp.asarray(padded), k)
    assert ab.dtype == torch.int32 and ab.shape == (len(ws_tuple), nt)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(K)[:nkc])
    for g, ws in enumerate(ws_tuple):
        np.testing.assert_array_equal(ab[g].numpy(), np.asarray(jscan._pair_ab_xla(K, ws - k + 1, nt, depth)))
    assert int(ab.abs().sum()) > 0


@pytest.mark.parametrize("seed,t", [(11, 512), (12, 1024)])
def test_k3_twin_and_split_pass_match_jax_split_pass(clusters, seed, t):
    """Per cluster, K3's bitmap (its plain twin) and the port's split pass
    (K5's twin) equal the JAX split pass's, over the first
    ceil(max nw / 512) blocks of a planted record crossing many tiles."""
    codes = _planted_codes(seed, 20_000, (2_500, 9_000, 15_000))
    n = codes.shape[0]
    jeng = _jax_engine(clusters.profiles)
    n_valids = np.array([n - e.ws + 1 for e in jeng.engines], dtype=np.int32)
    thr_ints = np.array([e._thr_int(x) for e, x in zip(jeng.engines, THRS)], dtype=np.int32)
    jprep = jeng.engines[0].prepare_codes(codes, max_ws=jeng.max_ws)
    split = np.asarray(jcluster._cluster_record_bitmaps(
        jprep.dev, jnp.asarray(n_valids), jeng.s_stack, jnp.asarray(thr_ints),
        k=6, span=jeng.chunk, block=jeng.block, n_spans=jprep.n_spans, use_pallas=False,
        groups=jeng.groups,
    ))  # (n_spans, m, blocks)
    m = len(jeng.engines)
    want = split.transpose(1, 0, 2).reshape(m, -1)
    n_blocks = -(-int(n_valids.max()) // 512)

    port = _port_engine(clusters.profiles)
    port.fused_t = t
    prep = port.prepare_codes(codes)
    nws = n_valids.tolist()
    l0s = torch.stack([
        tscan._first_window_l0(prep, e.s_dev, k=6, ws=e.ws, r=e.r, depth=port.groups[0][1]) for e in port.engines
    ])
    got = fused_cluster_record_bitmaps(
        prep, port.s_stack, thr_ints.tolist(), l0s, nws,
        k=6, specs=port.specs, depth=port.groups[0][1], t=t, block=512, n_tiles=-(-max(nws) // t),
    )
    assert got.dtype == torch.int32 and got.shape[0] == m
    np.testing.assert_array_equal(got[:, :n_blocks].numpy().astype(bool), want[:, :n_blocks])
    assert torch.equal(port._fused_bitmaps(prep, nws, thr_ints.tolist()), got.bool())
    split_port = port._split_bitmaps(prep, nws, thr_ints.tolist())
    np.testing.assert_array_equal(split_port[:, :n_blocks].numpy(), want[:, :n_blocks])
    assert 0 < int(got.sum()) < m * n_blocks


def test_k8_twin_returns_the_stack(clusters):
    s_stack, specs = tscan.profiles_to_torch(clusters.profiles, "cpu")
    assert s_stack.dtype == torch.int32 and s_stack.shape == (6, 4**6)
    assert specs == [(p.windowsize, p.n_records) for p in clusters.profiles]
    assert torch.equal(lookup_roundtrip(s_stack, t=4096, w_min=283, w_max=285), s_stack)


# --- the cluster engine's streams against the JAX engine -------------------


@pytest.mark.parametrize("fixture", ["Alp_V_locus.fasta", "Loci.fasta", "8_ident_Alp_V_loci.fasta", "Alp_V_ref.fasta"])
def test_streams_match_jax_on_fixtures(clusters, fixture):
    """Both routes (the split pass, and K3 with fused_min_windows = 1)
    give the JAX engine's (dist0, stream) for every cluster, on every
    record of the fixture that the cluster miner scans."""
    jeng = _jax_engine(clusters.profiles)
    split, fused = _port_engine(clusters.profiles), _port_engine(clusters.profiles, fused=True)
    n_streamed = 0
    for rec in as_records(str(DATA / fixture)):
        if len(rec) - jeng.max_ws - 6 + 2 < 1:
            continue  # mine_genome_clusters skips it
        want = jeng.record_streams(rec.codes, THRS)
        assert split.record_streams(rec.codes, THRS) == want, rec.identifier
        assert fused.record_streams(rec.codes, THRS) == want, rec.identifier
        n_streamed += sum(len(s) for _d0, s in want)
    assert n_streamed > 0


@pytest.mark.parametrize("seed,small_buckets", [(21, False), (22, True)])
def test_streams_match_jax_on_planted_records(clusters, seed, small_buckets, monkeypatch):
    """Planted records on both routes.  With region and run buckets far
    below the record's needs, a cluster whose regions overflow reruns its
    plan once, at the bucket that fits, a cluster whose runs overflow
    reruns its reduce alone once, and no engine's buckets change."""
    codes = _planted_codes(seed, 40_000, range(2_000, 38_000, 4_500))
    want = _jax_engine(clusters.profiles).record_streams(codes, THRS)
    assert sum(len(s) for _d0, s in want) > 40
    for fused in (False, True):
        port = _port_engine(clusters.profiles, fused=fused)
        regions_calls = [0] * len(port.engines)
        reduce_calls = [0]
        if small_buckets:
            for ci, e in enumerate(port.engines):
                e.plan_regions, e.run_bucket = 2, 4

                def regions(*a, _real=e._regions, _ci=ci, **kw):
                    regions_calls[_ci] += 1
                    return _real(*a, **kw)

                monkeypatch.setattr(e, "_regions", regions)
            real_reduce = tscan._device_run_reduce

            def reduce(*a, **kw):
                reduce_calls[0] += 1
                return real_reduce(*a, **kw)

            monkeypatch.setattr(tscan, "_device_run_reduce", reduce)
        assert port.record_streams(codes, THRS) == want
        if small_buckets:
            run_overflows = sum(len(s) > 8 for _d0, s in want)  # > 4 runs: a run gives <= 2 entries
            assert set(regions_calls) == {2}  # every cluster's plan reran exactly once
            assert reduce_calls[0] >= sum(regions_calls) + run_overflows > sum(regions_calls)
            assert all(e.plan_regions == 2 and e.run_bucket == 4 for e in port.engines)
            monkeypatch.undo()


def test_device_tensor_input_gives_the_numpy_streams(clusters):
    """A record already on the engine's device (an int8 tensor, the bench's
    resident genome) gives the streams of the same record from numpy, on
    both routes; a tensor on another device is refused."""
    codes = _planted_codes(23, 40_000, range(2_000, 38_000, 4_500))
    for fused in (False, True):
        port = _port_engine(clusters.profiles, fused=fused)
        want = port.record_streams(codes, THRS)
        assert sum(len(s) for _d0, s in want) > 0
        assert port.record_streams(torch.from_numpy(codes), THRS) == want
    with pytest.raises(ValueError, match="engine on"):
        port.record_streams(torch.from_numpy(codes).to("meta"), THRS)


def test_cluster_fuzz_vs_int64_host_oracle():
    """Random cluster sets (k 4..6, m 2..4, windowsizes within 3 of each
    other) vs an independent oracle: each cluster's full stream from the
    exact int64 host distances, both replayed through replay_omn to
    identical hit events (tests/test_conformance_fuzz.py's cluster
    campaign, with the port's engine); both routes."""
    for seed in range(3):
        rng = np.random.default_rng(400 + seed)
        k = int(rng.integers(4, 7))
        m = int(rng.integers(2, 5))
        n = int(rng.integers(20_000, 30_000))
        base_ws = int(rng.integers(80, 200))
        wss = [base_ws + int(rng.integers(0, 4)) for _ in range(m)]
        refs = [[rng.integers(0, 4, ws, dtype=np.int8) for _ in range(int(rng.integers(1, 6)))] for ws in wss]
        profiles = []
        for ws, rr in zip(wss, refs):
            s = sum(kmer_count(x, k).astype(np.int64) for x in rr)
            profiles.append(RefProfile(mean_kfv=s / len(rr), sum_kfv=s, n_records=len(rr), windowsize=ws, consensus="A" * ws, k=k))
        codes = rng.integers(0, 4, n, dtype=np.int8)
        for pos in range(2_000, n - 300, int(rng.integers(3_000, 6_000))):
            src = refs[pos % m]
            mutant = src[pos % len(src)].copy()
            idx = rng.integers(0, mutant.shape[0], mutant.shape[0] // 6)
            mutant[idx] = rng.integers(0, 4, idx.shape[0])
            codes[pos : pos + mutant.shape[0]] = mutant
        imax = n - max(wss) - k + 2
        thrs, want = [], []
        for p in profiles:
            d = scan_window_distances_np_i64(codes, p.sum_kfv, k, p.windowsize, p.n_records)
            scale = 2.0 * k * p.n_records**2
            thr = float(np.percentile(d / scale, float(rng.uniform(1.5, 5.0))))
            below = (d / scale) < thr
            below[imax + 1 :] = False
            mask = below.copy()
            mask[1:] |= below[:-1]
            mask[0] = False
            mask[imax + 2 :] = False
            idx = np.nonzero(mask)[0]
            thrs.append(thr)
            want.append((float(d[0]) / scale, list(zip(idx.tolist(), (d[idx] / scale).tolist()))))

        def events(pairs):
            out = []
            replay_omn(
                [p[1] for p in pairs], [p[0] for p in pairs], thrs, k, wss, n,
                lambda ev: out.append((ev.cluster, ev.cmi, ev.dist, ev.edge_dist)) or True,
            )
            return out

        got = _port_engine(profiles, k=k, fused=bool(seed % 2)).record_streams(codes, thrs)
        assert [g[0] for g in got] == [w[0] for w in want]
        assert events(got) == events(want), (seed, k, m)
        assert len(events(want)) > 0


# --- mixed pair depths: K4 for group 0, K6 for the others -------------------


MIXED_THRS = [*THRS, 1.14]


@pytest.fixture(scope="module")
def mixed(clusters):
    """The six Alp_V clusters plus a profile of the genes' 20 bp prefixes:
    ws 20 clamps its pair depth to ws - k = 14, the others keep 16."""
    prefixes = gen_ref_ws_cons([FastaRecord(r.description, r.seq[:20]) for r in as_records(str(DATA / "Alp_V_ref.fasta"))], 6)
    return [*clusters.profiles, prefixes]


def test_mixed_depth_groups_and_route(mixed, monkeypatch):
    """Groups carry their own depth, in the JAX engine's order, and a
    mixed set takes the split pass at every record length, never K3."""
    port = _port_engine(mixed, fused=True)
    assert port.groups == _jax_engine(mixed).groups
    assert [(g[0], g[1]) for g in port.groups] == [(20, 14), (288, 16), (289, 16), (290, 16)]
    assert not port.one_depth and _port_engine(mixed[:6]).one_depth

    def no_k3(*a, **kw):
        raise AssertionError("K3 on a mixed-depth set")

    monkeypatch.setattr(port, "_fused_bitmaps", no_k3)
    assert any(s for _d0, s in port.record_streams(_planted_codes(31, 70_000, range(2_000, 68_000, 6_000)), MIXED_THRS))


@pytest.mark.parametrize("fixture", ["Alp_V_locus.fasta", "Loci.fasta", "8_ident_Alp_V_loci.fasta", "Alp_V_ref.fasta"])
def test_mixed_depth_streams_match_jax_on_fixtures(mixed, fixture):
    """Every cluster's (dist0, stream) equals the JAX split pass's (K4 and
    K6's XLA formulation) on every record the cluster miner scans."""
    jeng, port = _jax_engine(mixed), _port_engine(mixed)
    n_streamed = 0
    for rec in as_records(str(DATA / fixture)):
        if len(rec) - jeng.max_ws - 6 + 2 < 1:
            continue
        want = jeng.record_streams(rec.codes, MIXED_THRS)
        assert port.record_streams(rec.codes, MIXED_THRS) == want, rec.identifier
        n_streamed += sum(len(s) for _d0, s in want)
    assert n_streamed > 0


def test_mixed_depth_split_pass_matches_jax(mixed):
    """The split pass's bitmaps (K4 + K6 twins) equal the JAX split pass's."""
    codes = _planted_codes(13, 20_000, (2_500, 9_000, 15_000))
    n = codes.shape[0]
    jeng = _jax_engine(mixed)
    n_valids = np.array([n - e.ws + 1 for e in jeng.engines], dtype=np.int32)
    thr_ints = np.array([e._thr_int(x) for e, x in zip(jeng.engines, MIXED_THRS)], dtype=np.int32)
    jprep = jeng.engines[0].prepare_codes(codes, max_ws=jeng.max_ws)
    split = np.asarray(jcluster._cluster_record_bitmaps(
        jprep.dev, jnp.asarray(n_valids), jeng.s_stack, jnp.asarray(thr_ints),
        k=6, span=jeng.chunk, block=jeng.block, n_spans=jprep.n_spans, use_pallas=False,
        groups=jeng.groups,
    ))
    m = len(mixed)
    want = split.transpose(1, 0, 2).reshape(m, -1)
    n_blocks = -(-int(n_valids.max()) // 512)
    port = _port_engine(mixed)
    got = port._split_bitmaps(port.prepare_codes(codes), n_valids.tolist(), thr_ints.tolist())
    np.testing.assert_array_equal(got[:, :n_blocks].numpy(), want[:, :n_blocks])
    assert 0 < int(got[-1].sum()) and int(got.sum()) < m * n_blocks


def test_mixed_depth_fuzz_vs_int64_host_oracle():
    """Random sets with one cluster of windowsize below k + 16 (k 4..6),
    against each cluster's full int64 stream, both replayed through
    replay_omn to identical hit events."""
    for seed in range(2):
        rng = np.random.default_rng(700 + seed)
        k = int(rng.integers(4, 7))
        wss = [k + int(rng.integers(5, 12)), *(int(rng.integers(80, 120)) for _ in range(2))]
        refs = [[rng.integers(0, 4, ws, dtype=np.int8) for _ in range(int(rng.integers(1, 5)))] for ws in wss]
        profiles = []
        for ws, rr in zip(wss, refs):
            s = sum(kmer_count(x, k).astype(np.int64) for x in rr)
            profiles.append(RefProfile(mean_kfv=s / len(rr), sum_kfv=s, n_records=len(rr), windowsize=ws, consensus="A" * ws, k=k))
        n = 15_000
        codes = rng.integers(0, 4, n, dtype=np.int8)
        for pos in range(1_000, n - 200, 2_500):
            src = refs[pos % len(wss)]
            codes[pos : pos + src[0].shape[0]] = src[0]
        imax = n - max(wss) - k + 2
        thrs, want = [], []
        for p in profiles:
            d = scan_window_distances_np_i64(codes, p.sum_kfv, k, p.windowsize, p.n_records)
            scale = 2.0 * k * p.n_records**2
            thr = float(np.percentile(d / scale, 2.0))
            below = (d / scale) < thr
            below[imax + 1 :] = False
            mask = below.copy()
            mask[1:] |= below[:-1]
            mask[0] = False
            mask[imax + 2 :] = False
            idx = np.nonzero(mask)[0]
            thrs.append(thr)
            want.append((float(d[0]) / scale, list(zip(idx.tolist(), (d[idx] / scale).tolist()))))

        def events(pairs):
            out = []
            replay_omn(
                [p[1] for p in pairs], [p[0] for p in pairs], thrs, k, wss, n,
                lambda ev: out.append((ev.cluster, ev.cmi, ev.dist, ev.edge_dist)) or True,
            )
            return out

        port = _port_engine(profiles, k=k)
        assert not port.one_depth
        got = port.record_streams(codes, thrs)
        assert [g[0] for g in got] == [w[0] for w in want]
        assert events(got) == events(want) and len(events(want)) > 0, (seed, k, wss)


# --- miner and API through the port ----------------------------------------


def test_find_genes_cluster_mode_golden(mini_genome, ref_fasta):
    # tests/test_api_golden.py::test_find_genes_cluster_mode_golden
    a = kt.find_genes_cluster_mode(
        genome_path=mini_genome, ref_path=ref_fasta, kmer_dist_thrs=THRS, buffer=100, verbose=False, device="cpu",
    )[0]
    assert [h.description for h in a] == [
        "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
        "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
        "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
    ]


def test_omn_miner_custom_thresholds(ref_fasta, mini_genome):
    # tests/test_miner_golden.py::TestOmnMiner::test_custom_thresholds
    clusters = cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25], include_avg=False)
    res = mine_genome_clusters(mini_genome, clusters.profiles, thr_vec=[37, 33, 38, 34, 28], buff=200, device="cpu")
    assert [h.description for h in res.hits] == [
        "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
        "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24198 | GenomePos = 0 | Len = 292",
        "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
    ]


def test_low_k_warns_cluster(mini_genome, ref_fasta):
    with pytest.warns(UserWarning, match="Such a low k value of 3"):
        kt.find_genes_cluster_mode(genome_path=mini_genome, ref_path=ref_fasta, k=3, verbose=False, device="cpu")


def test_too_high_thresholds_warn(mini_genome, ref_fasta):
    with pytest.warns(UserWarning, match=r"at index/indicies 1, 2, 4, 5, 6 for k = 6"):
        kt.find_genes_cluster_mode(
            genome_path=mini_genome, ref_path=ref_fasta, verbose=False, device="cpu",
            kmer_dist_thrs=[100.0, 200.0, 20.0, 300.0, 200.0, 100.0],
        )


def test_return_dists_and_outputs_match_jax_miner(clusters, mini_genome):
    """do_return_dists (each cluster's whole-record K2 scan), hit loci and
    alignments through the port's miner equal the JAX miner's."""
    kw = dict(thr_vec=THRS, buff=100, do_return_dists=True, do_return_align=True, get_hit_loci=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = mine_genome_clusters(mini_genome, clusters.profiles, device="cpu", **kw)
        want = jax_mine_genome_clusters(mini_genome, clusters.profiles, **kw)
    assert [(h.description, h.seq) for h in got.hits] == [(h.description, h.seq) for h in want.hits]
    assert got.hit_loci == want.hit_loci and len(got.hit_loci) == 3
    assert [a.cigar for a in got.alignments] == [a.cigar for a in want.alignments]
    assert len(got.dists) == len(want.dists) == 6
    for g, w in zip(got.dists, want.dists):
        assert g.shape == w.shape == (41260 - 290 - 6 + 2,)
        np.testing.assert_array_equal(g, w)


# --- what raises -----------------------------------------------------------


@pytest.mark.parametrize("kwarg", ["devices"])
def test_unported_options_raise(mini_genome, ref_fasta, kwarg):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 2"):
        kt.find_genes_cluster_mode(mini_genome, ref_fasta, verbose=False, device="cpu", **{kwarg: 2})


def test_threshold_count_mismatch_raises(clusters, mini_genome):
    eng = _port_engine(clusters.profiles)
    with pytest.raises(ValueError, match="6 clusters but 2 thresholds"):
        eng.record_streams(np.zeros(1_000, dtype=np.int8), [1.0, 2.0])
    with pytest.raises(ValueError, match="thresholds"):
        mine_genome_clusters(mini_genome, clusters.profiles, thr_vec=[30.0] * 5, device="cpu")
