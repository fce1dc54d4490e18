"""The PyTorch engine (kmergma_tpu_torch.ops.scan.ScanEngine) against the
JAX engine (kmergma_tpu.ops.scan.ScanEngine): (dist0, stream) bit-identical
on every record of the four fixtures and on seeded random records with
planted genes.  Zero tolerance: the streams are integer distances divided
by the same float64 scale.

The JAX engine runs with ``full_fetch_windows = 0``, so it assembles the
minimal run-reduced stream that the port always produces (its raw-distance
cutover is another route to the same hits, not the same stream)."""

import numpy as np
import pytest
import torch

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops.kmers import kmer_count
from kmergma_tpu.ops.reference import gen_ref_ws_cons
from kmergma_tpu.ops.scan_host import scan_window_distances_np_i64
from kmergma_tpu.utils.fasta import as_records
from kmergma_tpu_torch.ops import scan as tscan

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _jax_engine(s, k, ws, r, **kw):
    eng = jscan.ScanEngine(s, k=k, ws=ws, r=r, **kw)
    eng.full_fetch_windows = 0
    return eng


def _planted(seed, n=50_000, k=6, ws=240, r=5):
    """Random background with mutated copies of r random references."""
    rng = np.random.default_rng(seed)
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(2_000, n - ws - 100, 5_000):
        mutant = refs[pos % r].copy()
        idx = rng.integers(0, ws, ws // 5)
        mutant[idx] = rng.integers(0, 4, idx.shape[0])
        codes[pos : pos + ws] = mutant
    return s, codes


@pytest.fixture(scope="module")
def profile6(ref_fasta):
    return gen_ref_ws_cons(ref_fasta, 6)


@pytest.mark.parametrize(
    "fixture,thr",
    [
        ("Alp_V_locus.fasta", 30.0),
        ("Loci.fasta", 30.0),
        ("8_ident_Alp_V_loci.fasta", 36.0),
        ("Alp_V_ref.fasta", 36.0),
    ],
)
def test_streams_match_jax_on_fixtures(fixture, thr, profile6):
    from pathlib import Path

    path = Path(__file__).parent / "data" / fixture
    p = profile6
    port = tscan.ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, device="cpu")
    ref = _jax_engine(p.sum_kfv, 6, p.windowsize, p.n_records)
    if fixture == "Alp_V_ref.fasta":
        ref.plan_regions = 2  # its records hold one region each
    n_streamed = 0
    for rec in as_records(str(path)):
        if len(rec) < p.windowsize:
            continue
        got = port.record_stream(rec.codes, thr)
        want = ref.record_stream(rec.codes, thr)
        assert got[0] == want[0], rec.identifier
        assert got[1] == want[1], rec.identifier
        assert got[2] is None
        n_streamed += len(got[1])
    assert n_streamed > 0


@pytest.mark.parametrize("seed,thr_pct,small_buckets", [(0, 3.0, False), (1, 5.0, True), (2, 30.0, True)])
def test_streams_match_jax_on_planted_records(seed, thr_pct, small_buckets, monkeypatch):
    s, codes = _planted(seed)
    k, ws, r = 6, 240, 5
    port = tscan.ScanEngine(s, k=k, ws=ws, r=r, device="cpu")
    ref = _jax_engine(s, k, ws, r, chunk_windows=1 << 15)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = float(np.percentile(d / port.scale, thr_pct))
    calls = {"regions": 0, "reduce": 0}
    if small_buckets:
        # buckets far below the record's needs: both must rerun per record
        port.plan_regions = 2
        port.run_bucket = 4
        real_regions, real_reduce = port._regions, tscan._device_run_reduce

        def regions(*a, **kw):
            calls["regions"] += 1
            return real_regions(*a, **kw)

        def reduce(*a, **kw):
            calls["reduce"] += 1
            return real_reduce(*a, **kw)

        monkeypatch.setattr(port, "_regions", regions)
        monkeypatch.setattr(tscan, "_device_run_reduce", reduce)
    got = port.record_stream(codes, thr)
    want = ref.record_stream(codes, thr)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[1]) > 8
    if small_buckets:
        assert calls["regions"] == 2  # one rerun at the bucket that fits
        assert calls["reduce"] == 3  # plus one rerun of the reduce alone
        assert port.plan_regions == 2 and port.run_bucket == 4  # no engine-wide change


def test_collect_dists_matches_jax():
    s, codes = _planted(3, n=30_000)
    k, ws, r = 6, 240, 5
    port = tscan.ScanEngine(s, k=k, ws=ws, r=r, device="cpu")
    port.dists_chunk = 7_000  # several chunks: the stream stitches across them
    ref = _jax_engine(s, k, ws, r)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = float(np.percentile(d / port.scale, 4.0))
    got = port.record_stream(codes, thr, collect_dists=True)
    want = ref.record_stream(codes, thr, collect_dists=True)
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], d / port.scale)


def test_tiny_record_and_full_activity():
    """Every window below threshold, and a record shorter than one region:
    the plan clamps to the record."""
    s, codes = _planted(5, n=900)
    port = tscan.ScanEngine(s, k=6, ws=240, r=5, device="cpu")
    ref = _jax_engine(s, 6, 240, 5)
    got = port.record_stream(codes, 1e9)
    want = ref.record_stream(codes, 1e9)
    assert got[:2] == want[:2]


@pytest.mark.parametrize("k,ws,alphabet", [(6, 240, 4), (4, 40, 4), (1, 60, 256)])
def test_exact_mode_streams_match_jax(k, ws, alphabet):
    """bound_depth=None: the bitmap comes from K4's full-depth distances
    (K4r's use) instead of K1's bounds; streams equal the JAX exact
    engine's, for 2-bit codes and for a k = 1 engine over 256 codes
    (uint8, as the strobemer span engine ships them)."""
    r = 7
    if alphabet == 4:
        s, codes = _planted(k, n=20_000, k=k, ws=ws, r=r)
    else:
        rng = np.random.default_rng(17)
        s = rng.integers(0, 90, alphabet).astype(np.int64)
        codes = rng.integers(0, alphabet, 20_000).astype(np.uint8)
    port = tscan.ScanEngine(s, k=k, ws=ws, r=r, device="cpu", bound_depth=None)
    ref = _jax_engine(s, k, ws, r, bound_depth=None, chunk_windows=1 << 13)
    if alphabet > 4:
        port.codes_dtype = np.uint8
        ref.pack_codes = False
    d = jscan.scan_window_distances_np(codes.astype(np.int64), s, k, ws, r)
    thr = float(np.percentile(d / port.scale, 3.0))
    got = port.record_stream(codes, thr)
    want = ref.record_stream(codes.astype(np.int32) if alphabet > 4 else codes, thr)
    assert port.bound_depth is None and got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) > 4
    assert port.prepare_codes(codes).dtype == (torch.uint8 if alphabet > 4 else torch.int8)


@pytest.mark.parametrize("bound_depth", [283, 10_000])
def test_depth_past_bitmap_kernel_takes_exact_mode(bound_depth):
    """K1 runs on K3's kernel, whose pair counts are bytes (depth at most
    MAX_BITMAP_DEPTH).  A bound_depth past that which reaches the window's
    full depth (ws - k = 283 at ws 289, k 6, the Alp_V windowsize) takes
    exact mode: the bounds are then the distances, and the stream equals
    the JAX engine's at the same bound_depth."""
    k, ws, r = 6, 289, 5
    s, codes = _planted(5, n=30_000, k=k, ws=ws, r=r)
    port = tscan.ScanEngine(s, k=k, ws=ws, r=r, device="cpu", bound_depth=bound_depth)
    ref = _jax_engine(s, k, ws, r, bound_depth=bound_depth, chunk_windows=1 << 13)
    d = jscan.scan_window_distances_np(codes.astype(np.int64), s, k, ws, r)
    thr = float(np.percentile(d / port.scale, 3.0))
    got = port.record_stream(codes, thr)
    want = ref.record_stream(codes, thr)
    assert ws - k > tscan.MAX_BITMAP_DEPTH and port.bound_depth is None and ref.bound_depth == ws - k
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) > 4


def test_depth_past_bitmap_kernel_short_of_full_depth_raises():
    """A bound_depth above MAX_BITMAP_DEPTH but below ws - k is past K1's
    byte counts, whose wrapper still raises at it; the engine keeps the
    depth and routes its bitmap to K4 (the depth route) instead, and up to
    MAX_BITMAP_DEPTH it stays on K1.  Streams at such depths against the
    JAX engine: tests/test_torch_engine_options.py."""
    from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps

    s, codes = _planted(6, n=1_000, k=6, ws=289, r=5)
    deep = tscan.ScanEngine(s, k=6, ws=289, r=5, device="cpu", bound_depth=tscan.MAX_BITMAP_DEPTH + 1)
    edge = tscan.ScanEngine(s, k=6, ws=289, r=5, device="cpu", bound_depth=tscan.MAX_BITMAP_DEPTH)
    assert deep.bound_depth == 256 and not deep.on_k1
    assert edge.bound_depth == 255 and edge.on_k1
    prep = edge.prepare_codes(codes)  # padded for K1's tiles
    with pytest.raises(ValueError, match="depth <= 255"):
        fused_record_bitmaps(prep, deep.s_dev, thr=0, l0=torch.zeros((), dtype=torch.int32), nw=712, k=6, ws=289, r=5,
                             depth=256, t=4096, block=512, n_tiles=1)


def test_k10_on_one_device_matches_jax_host_engine():
    """Big k on one device (4^10 bins, a 4 MB int32 table: K1's __ldg
    route, K2 and the plain profile gather) at the inputs of the JAX
    package's k = 10 TP test: dist0 and the replayed hits equal the JAX
    int64 host engine's, and the miner keeps the single-device engine."""
    from kmergma_tpu.models.state_machine import replay_single as jax_replay_single
    from kmergma_tpu.ops.scan_host import HostScanEngine as JaxHostScanEngine
    from kmergma_tpu_torch.models.miner import _default_engine
    from kmergma_tpu_torch.models.state_machine import replay_single
    from kmergma_tpu_torch.ops.reference import RefProfile

    rng = np.random.default_rng(10)
    k, ws, r = 10, 1200, 3
    n = 9000
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[4000 : 4000 + ws] = rng.integers(0, 4, ws, dtype=np.int8)
    # the same background with two of the references planted: real hits
    planted = codes.copy()
    planted[1000 : 1000 + ws] = refs[0]
    planted[6500 : 6500 + ws] = refs[2]
    host = JaxHostScanEngine(s, k=k, ws=ws, r=r)
    port = tscan.ScanEngine(s, k=k, ws=ws, r=r, device="cpu")
    n_hits = 0
    for record, thr in ((codes, 120.0), (planted, 70.0)):
        d0_h, stream_h, _ = host.record_stream(record, thr)
        want = jax_replay_single(stream_h, d0_h, thr, k, ws, n, 50)
        d0, stream, _ = port.record_stream(record, thr)
        got = replay_single(stream, d0, thr, k, ws, n, 50)
        assert d0 == d0_h and len(stream) > 0
        assert [(h.cmi, h.dist, h.start, h.stop) for h in got] == [(h.cmi, h.dist, h.start, h.stop) for h in want]
        n_hits += len(got)
    assert n_hits >= 2
    profile = RefProfile(mean_kfv=s / r, sum_kfv=s, n_records=r, windowsize=ws, consensus="A" * ws, k=k)
    assert isinstance(_default_engine(profile, "cpu"), tscan.ScanEngine)


def test_alp_v_k10_profile_fits_int32(ref_fasta):
    """The harness's k = 10 row: the Alp_V profile at k = 10 passes the
    int32 headroom guard, as in the JAX package's k10 row."""
    p = gen_ref_ws_cons(ref_fasta, 10)
    tscan.check_int32_headroom(p.sum_kfv, p.windowsize, 10, p.n_records)
    assert tscan.ScanEngine(p.sum_kfv, k=10, ws=p.windowsize, r=p.n_records, device="cpu").s_dev.shape == (4**10,)
