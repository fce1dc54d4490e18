"""The scan engines' depth options on the port against the JAX engines, on
the CPU with the same inputs through both: ``ClusterScanEngine`` and
``ShardedClusterScanEngine`` at any ``bound_depth`` and in exact mode,
``ShardedScanEngine`` in exact mode and past ``MAX_BITMAP_DEPTH``,
``ScanEngine`` between ``MAX_BITMAP_DEPTH`` and the window's full depth,
and the strobe engine's ``chunk_windows`` / ``bound_depth`` and the
miner's ``device_extract=None``.  Zero tolerance: the streams are integer
distances divided by the same float64 scale.

Each JAX engine runs with ``full_fetch_windows = 0``, so it assembles the
minimal run-reduced streams that the port always produces.  On CPU
tensors the kernel wrappers run their plain twins; spies on the wrappers
show which kernel each route would launch on the card: a depth past
``MAX_BITMAP_DEPTH`` is routed to K4 (and K6) by shape, before any call
of K1, K3 or K5, whose wrappers still refuse it."""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from kmergma_tpu.models import strobe_miner as jstrobe
from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops import scan_cluster as jcluster
from kmergma_tpu.parallel import sharded_scan as jsharded
from kmergma_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmergma_tpu.utils.fasta import FastaRecord as JaxFastaRecord
from kmergma_tpu_torch.models import strobe_miner as tstrobe
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops import scan_cluster as tcluster
from kmergma_tpu_torch.ops import scan_cluster_fused as tfused
from kmergma_tpu_torch.ops import scan_fused as tk1
from kmergma_tpu_torch.ops import scan_kernels as tkernels
from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes
from kmergma_tpu_torch.parallel import sharded_scan as tsharded
from kmergma_tpu_torch.parallel.mesh import make_mesh
from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_engine import _jax_engine, _planted

DATA = Path(__file__).parent / "data"
REF = str(DATA / "Alp_V_ref.fasta")
#: the reference's cluster golden thresholds, one per Alp_V cluster
CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
#: the Alp_V single profile's threshold (the single-profile golden)
THR = 30.0


@pytest.fixture(scope="module")
def locus() -> np.ndarray:
    """The Alp_V locus, 41,260 bp."""
    return as_records(str(DATA / "Alp_V_locus.fasta"))[0].codes


@pytest.fixture(scope="module")
def clusters():
    """The Alp_V set at k = 6, cutoffs [7, 12, 20, 25]: six clusters,
    windowsizes 288-290 (pair depths 282-284 in exact mode)."""
    return eliminate_null_params(cluster_ref_api(REF, 6, cutoffs=[7, 12, 20, 25]))


@pytest.fixture(scope="module")
def profile():
    """The Alp_V single profile: ws 289, k 6, full depth 283."""
    return gen_ref_ws_cons(REF, 6)


@pytest.fixture(scope="module")
def jax_cluster_streams(clusters, locus):
    """The JAX cluster engine's streams on the locus, by bound_depth (each
    computed once, when a test first asks for it)."""
    cache: dict = {}

    def get(depth):
        if depth not in cache:
            eng = jcluster.ClusterScanEngine(clusters.profiles, k=6, chunk_windows=1 << 18, use_fused=False,
                                             bound_depth=depth)
            eng.engines[0].full_fetch_windows = 0
            cache[depth] = eng.record_streams(locus, CLUSTER_THRS)
        return cache[depth]

    return get


@pytest.fixture(scope="module")
def default_cluster_streams(clusters, locus):
    """The port's cluster engine's streams on the locus at the default
    depth, 16."""
    return tcluster.ClusterScanEngine(clusters.profiles, k=6, device="cpu").record_streams(locus, CLUSTER_THRS)


class _Spy:
    """Counts the calls of kernel wrappers and the depths they were given,
    by wrapper name."""

    def __init__(self, monkeypatch):
        self.depths: dict = {}
        wrappers = [
            (tkernels, "codes_pair_multi", "K5"),
            (tkernels, "codes_pair_ab_kcodes", "K4"),
            (tkernels, "pair_ab_from_kcodes", "K6"),
            (tfused, "fused_cluster_record_bitmaps", "K3"),
            (tk1, "fused_record_bitmaps", "K1"),
        ]
        for mod, name, label in wrappers:
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name), label))

    def _wrap(self, fn, label):
        params = list(inspect.signature(fn).parameters)

        def spy(*args, **kwargs):
            depth = kwargs["depth"] if "depth" in kwargs else args[params.index("depth")]
            self.depths.setdefault(label, []).append(depth)
            return fn(*args, **kwargs)

        return spy

    def kernels(self) -> set:
        return set(self.depths)


def _same_streams(got, want) -> None:
    assert len(got) == len(want)
    for (d0, s), (w0, ws) in zip(got, want):
        assert d0 == w0 and s == ws


# --- cluster mode -----------------------------------------------------------


@pytest.mark.parametrize("route", ["split", "k3"])
@pytest.mark.parametrize("depth", [None, 8, 32, 270], ids=["exact", "d8", "d32", "d270"])
def test_cluster_engine_depths_match_jax(clusters, locus, jax_cluster_streams, default_cluster_streams, monkeypatch, depth, route):
    """``ClusterScanEngine(bound_depth=)`` on the locus equals the JAX
    engine at the same depth, on the split route and where K3 is asked for
    (``fused_min_windows = 1``).  At 8 and 32 the clusters share one depth,
    so K5 (split) or K3 takes it; exact mode mixes the depths 282-284 and
    270 is past the byte counts, so both routes take K4 and K6."""
    eng = tcluster.ClusterScanEngine(clusters.profiles, k=6, device="cpu", bound_depth=depth)
    if route == "k3":
        eng.fused_min_windows = 1
    spy = _Spy(monkeypatch)
    got = eng.record_streams(locus, CLUSTER_THRS)
    _same_streams(got, jax_cluster_streams(depth))
    # a deeper or exact bitmap only narrows the regions: the default
    # depth's streams
    _same_streams(got, default_cluster_streams)
    assert sum(len(s) for _d0, s in got) > 6
    if depth in (8, 32):
        assert eng.shared_depth == depth
        assert spy.kernels() == ({"K3"} if route == "k3" else {"K5"}) and set(sum(spy.depths.values(), [])) == {depth}
    else:
        want_depths = [282, 283, 284] if depth is None else [270]
        assert eng.shared_depth is None and sorted({g[1] for g in eng.groups}) == want_depths
        assert spy.kernels() == {"K4", "K6"} and len(spy.depths["K4"]) == 1


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("depth", [None, 32], ids=["exact", "d32"])
def test_sharded_cluster_engine_depths_match_jax(clusters, locus, jax_cluster_streams, depth, n_dev):
    """``ShardedClusterScanEngine(bound_depth=)`` over 1 and 4 logical CPU
    shards equals the JAX engine at that depth; each shard takes the
    one-device route of its own length."""
    eng = tsharded.ShardedClusterScanEngine(clusters.profiles, k=6, mesh=make_mesh(n_dev, device="cpu"),
                                            bound_depth=depth, device="cpu")
    assert [e.bound_depth for e in eng.engines] == [None if depth is None else 32] * 6
    _same_streams(eng.record_streams(locus, CLUSTER_THRS), jax_cluster_streams(depth))


def test_byte_count_kernels_refuse_past_255():
    """K5's and K3's wrappers (and K1's, K3's kernel at m = 1) keep their
    depth <= MAX_BITMAP_DEPTH check: the engines route deeper bounds to K4
    and K6 before any launch."""
    depth = tscan.MAX_BITMAP_DEPTH + 1
    codes = torch.zeros(8192, dtype=torch.int8)
    with pytest.raises(ValueError, match="depth <= 255"):
        tkernels.codes_pair_multi(codes, 6, (289, 290), 1000, 1300, depth)
    s = torch.zeros((2, 4**6), dtype=torch.int32)
    with pytest.raises(ValueError, match="depth <= 255"):
        tfused.fused_cluster_record_bitmaps(codes, s, thrs=[1, 1], l0s=torch.zeros(2, dtype=torch.int32), nws=[100, 100], k=6,
                                            specs=[(289, 5), (290, 5)], depth=depth, t=4096, block=512, n_tiles=1)
    with pytest.raises(ValueError, match="depth <= 255"):
        tk1.fused_record_bitmaps(codes, s[0], thr=1, l0=torch.zeros((), dtype=torch.int32), nw=100, k=6, ws=289, r=5,
                                 depth=depth, t=4096, block=512, n_tiles=1)


# --- one profile: ScanEngine and ShardedScanEngine ---------------------------


@pytest.mark.parametrize("depth", [256, 270, 282])
def test_scan_engine_between_255_and_full_depth_matches_jax(profile, locus, monkeypatch, depth):
    """``ScanEngine`` at a depth past K1's byte counts and short of the
    window's full depth (283 at ws 289, k 6) keeps that depth, takes K4 at
    it, and its stream on the locus equals the JAX engine's."""
    k, ws, r = 6, profile.windowsize, profile.n_records
    port = tscan.ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device="cpu", bound_depth=depth)
    ref = _jax_engine(profile.sum_kfv, k, ws, r, bound_depth=depth, chunk_windows=1 << 13)
    spy = _Spy(monkeypatch)
    got = port.record_stream(locus, THR)
    want = ref.record_stream(locus, THR)
    assert port.bound_depth == depth and not port.on_k1
    assert spy.depths == {"K4": [depth]}
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) > 4


def test_scan_engine_depth_300_at_ws_400_k4_matches_jax(monkeypatch):
    """The k = 4, ws = 400 record of seed 3 at bound_depth 300 (full depth
    396), which the engine used to refuse: K4 at depth 300, and the stream
    equals the JAX engine's."""
    k, ws, r = 4, 400, 5
    s, codes = _planted(3, n=30_000, k=k, ws=ws, r=r)
    port = tscan.ScanEngine(s, k=k, ws=ws, r=r, device="cpu", bound_depth=300)
    ref = _jax_engine(s, k, ws, r, bound_depth=300, chunk_windows=1 << 13)
    d = jscan.scan_window_distances_np(codes.astype(np.int64), s, k, ws, r)
    thr = float(np.percentile(d / port.scale, 3.0))
    spy = _Spy(monkeypatch)
    got = port.record_stream(codes, thr)
    want = ref.record_stream(codes, thr)
    assert spy.depths == {"K4": [300]}
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) > 4


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("depth", [None, 270], ids=["exact", "d270"])
def test_sharded_scan_engine_depths_match_jax(profile, locus, monkeypatch, depth, n_dev):
    """``ShardedScanEngine`` in exact mode and at 270 over 1, 2 and 4
    logical CPU shards equals the JAX sharded engine over ``make_mesh(n)``:
    each shard's bitmap comes from K4 on its own device with its own copy
    of the profile, at the depth (283, the full depth, in exact mode)."""
    k, ws, r = 6, profile.windowsize, profile.n_records
    port = tsharded.ShardedScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=make_mesh(n_dev, device="cpu"),
                                      chunk_windows=2048, bound_depth=depth, device="cpu")
    ref = jsharded.ShardedScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=jax_make_mesh(n_dev),
                                     chunk_windows=2048, bound_depth=depth)
    ref.full_fetch_windows = 0
    spy = _Spy(monkeypatch)
    got = port.record_stream(locus, THR)
    want = ref.record_stream(locus, THR)
    assert spy.kernels() == {"K4"} and set(spy.depths["K4"]) == {ws - k if depth is None else depth}
    assert len(spy.depths["K4"]) == n_dev  # one a shard: the locus fills every shard
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) > 4


def test_sharded_depth_route_pads_for_k4():
    """Each shard's codes are padded for K4's tiles on the depth route, and
    for K1's tiles and halo on K1."""
    s = np.ones(4**6, dtype=np.int64)
    n = 50_000
    exact = tsharded.ShardedScanEngine(s, k=6, ws=289, r=5, mesh=make_mesh(2, device="cpu"), bound_depth=None,
                                       device="cpu")
    k1 = tsharded.ShardedScanEngine(s, k=6, ws=289, r=5, mesh=make_mesh(2, device="cpu"), device="cpu")
    nw, w = n - 289 + 1, 284
    assert exact._padded_len(n) == max(n + 1025, tkernels._pair_depth_need(6, w, nw - 1, nw + w - 1)[1])
    assert k1._padded_len(n) == max(n + 1025, -(-nw // 4096) * 4096 + tscan._k1_halo(w))


# --- the strobe engine's options --------------------------------------------


@pytest.fixture(scope="module")
def strobe_profile():
    return tstrobe.gen_strobe_ref_ws_cons(REF)


@pytest.fixture(scope="module")
def strobe_records():
    """Two records of random background with Alp_V genes planted every
    6 kb (30 kb and 20 kb)."""
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    genes = [rec.codes for rec in as_records(REF)]
    out = []
    for seed, n in ((21, 30_000), (22, 20_000)):
        rng = np.random.default_rng(seed)
        codes = rng.integers(0, 4, n, dtype=np.int8)
        for i, pos in enumerate(range(1_000, n - 400, 6_000)):
            g = genes[(5 * i + seed) % len(genes)]
            codes[pos : pos + g.shape[0]] = g
        out.append(FastaRecord(f"r{seed}", letters[codes].tobytes()))
    return out


def test_bounded_strobe_engine_matches_jax(strobe_profile, strobe_records, monkeypatch):
    """``StrobeSpanEngine(bound_depth=16, chunk_windows=4096)``: K4 at depth
    16 over byte strobe codes (K1 reads 2-bit codes), each record of host
    codes scanned in segments of 8,192 windows; its streams equal the JAX
    engine's with the same options."""
    p = strobe_profile
    w = p.windowsize - p.k
    spy = _Spy(monkeypatch)
    for rec in strobe_records:
        sc = strobe_2_mer_codes(rec.codes, p.s, p.w_min, p.w_max, p.q)
        xstar = int(sc[w])
        n_steps = len(rec) - p.windowsize - 1
        port = tstrobe.StrobeSpanEngine(p, xstar, chunk_windows=4096, bound_depth=16, device="cpu")
        ref = jstrobe.StrobeSpanEngine(p, xstar, chunk_windows=4096, bound_depth=16)
        ref.full_fetch_windows = 0
        spy.depths.clear()
        got = port.record_stream(sc[: n_steps + w], THR)
        want = ref.record_stream(sc[: n_steps + w], THR)
        assert port.bound_depth == 16 and not port.on_k1
        segments = -(-(n_steps + 1) // 8192)
        assert segments > 1 and spy.depths == {"K4": [16] * segments}
        assert got[0] == want[0] and got[1] == want[1]


def test_strobe_miner_chunk_windows_and_device_extract_match_jax(strobe_profile, strobe_records):
    """``strobe_mine_genome(chunk_windows=4096, device_extract=None)``: on
    the CPU the default extracts on the host, as the JAX miner's does off
    the accelerator; the hits equal the JAX miner's with the same options,
    and so do those of a miner whose engines are bounded at depth 16."""
    jax_records = [JaxFastaRecord(rec.description, rec.seq) for rec in strobe_records]
    kw = dict(thr=THR, get_hit_loci=True, chunk_windows=4096)
    want = jstrobe.strobe_mine_genome(jax_records, strobe_profile, device_extract=None, **kw)
    got = tstrobe.strobe_mine_genome(strobe_records, strobe_profile, device_extract=None, device="cpu", **kw)
    bounded = tstrobe.strobe_mine_genome(
        strobe_records, strobe_profile, device="cpu",
        engine_factory=lambda p, x: tstrobe.StrobeSpanEngine(p, x, chunk_windows=4096, bound_depth=16, device="cpu"),
        **kw,
    )
    for res in (got, bounded):
        assert [(h.description, h.seq) for h in res.hits] == [(h.description, h.seq) for h in want.hits]
        assert res.hit_loci == want.hit_loci
    assert len(want.hits) > 2


def test_strobe_miner_device_extract_default_follows_the_device(strobe_profile, strobe_records, monkeypatch):
    """``device_extract=None`` extracts on the device when ``genome_dev`` is
    given (and on a card), on the host otherwise."""
    calls = []
    real = tstrobe.strobe_2_mer_codes_torch
    monkeypatch.setattr(tstrobe, "strobe_2_mer_codes_torch", lambda *a: calls.append(1) or real(*a))
    rec = strobe_records[1]
    host = tstrobe.strobe_mine_genome([rec], strobe_profile, thr=THR, do_align=False, device="cpu")
    assert calls == []
    dev = tstrobe.strobe_mine_genome([rec], strobe_profile, thr=THR, do_align=False, device="cpu",
                                     genome_dev=[torch.from_numpy(rec.codes)])
    assert calls == [1] and [h.description for h in dev.hits] == [h.description for h in host.hits]


# --- the signatures ---------------------------------------------------------

#: the JAX parameters the port leaves out on purpose (ROADMAP.md)
_LEFT_OUT = {"use_pallas", "use_fused", "pair_kernel"}
#: the port's own parameters beyond ``device``
_PORT_ONLY = {"strobe_mine_genome": {"engine_factory"}}


@pytest.mark.parametrize("name", ["ScanEngine", "ShardedScanEngine", "ClusterScanEngine", "ShardedClusterScanEngine",
                                  "StrobeSpanEngine", "strobe_mine_genome"])
def test_engine_signatures_have_the_jax_names(name):
    """Each callable takes the JAX package's parameter names, with the same
    defaults, apart from ``device`` and the parameters left out on
    purpose."""
    from kmergma_tpu.ops import scan_cluster as jsc

    jax_mods = {"ScanEngine": jscan, "ShardedScanEngine": jsharded, "ClusterScanEngine": jsc,
                "ShardedClusterScanEngine": jsharded, "StrobeSpanEngine": jstrobe, "strobe_mine_genome": jstrobe}
    port_mods = {"ScanEngine": tscan, "ShardedScanEngine": tsharded, "ClusterScanEngine": tcluster,
                 "ShardedClusterScanEngine": tsharded, "StrobeSpanEngine": tstrobe, "strobe_mine_genome": tstrobe}
    want = inspect.signature(getattr(jax_mods[name], name)).parameters
    got = inspect.signature(getattr(port_mods[name], name)).parameters
    assert set(want) - _LEFT_OUT == set(got) - {"device"} - _PORT_ONLY.get(name, set())
    for p in set(want) - _LEFT_OUT:
        assert got[p].default == want[p].default, p
