"""The hand-written CUDA kernels against their plain PyTorch twins.

The kernel tests need a CUDA device and skip without one (marker
``cuda``); on the CPU the wrappers run their plain twins, launch nothing,
and refuse other devices.  Zero tolerance: integer arithmetic.

The file imports only the port (no jax, no JAX package) and no conftest
fixture, so on a GPU host without jax it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.kmers import kmer_count
from kmergma_tpu_torch.ops.reference import RefProfile, cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
from kmergma_tpu_torch.ops.scan_cluster_fused import (
    _lookup_roundtrip_plain,
    cluster_tables_in_smem,
    fused_cluster_record_bitmaps,
    fused_cluster_record_bitmaps_plain,
    lookup_roundtrip,
)
from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps, fused_record_bitmaps_plain
from kmergma_tpu_torch.ops.scan_kernels import (
    _codes_pair_ab_kcodes_plain,
    _codes_pair_multi_plain,
    _match_counts_plain,
    codes_pair_ab_kcodes,
    codes_pair_multi,
    match_counts,
    _run_reduce_multi_plain,
    pair_ab_from_kcodes,
    run_reduce_multi,
    scan_window_distances_kernel,
)
from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes
from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

from ._k5_cases import K5_CASES, k5_case
from ._r1_cases import R1_CASES, r1_case
from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


REF = str(Path(__file__).parent / "data" / "Alp_V_ref.fasta")


@pytest.fixture(scope="module")
def record():
    """(codes, profile): a seeded 300 kb record with 30 planted genes."""
    p = gen_ref_ws_cons(REF, 6)
    genes = [rec.codes for rec in as_records(REF)]
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 300_000, dtype=np.int8)
    for j, pos in enumerate(range(5_000, 295_000, 10_000)):
        codes[pos : pos + genes[j].shape[0]] = genes[j]
    return codes, p


def _bitmap_inputs(codes, s, k, ws, r, device):
    eng = tscan.ScanEngine(s, k=k, ws=ws, r=r, device=device)
    prep = eng.prepare_codes(codes)
    nw = codes.shape[0] - ws + 1
    l0 = tscan._first_window_l0(prep, eng.s_dev, k=k, ws=ws, r=r, depth=eng.bound_depth)
    kw = dict(k=k, ws=ws, r=r, depth=eng.bound_depth, t=eng.fused_t, block=eng.block,
              n_tiles=-(-nw // eng.fused_t))
    return eng, prep, nw, l0, kw


WRAPPERS = (
    fused_record_bitmaps, match_counts, fused_cluster_record_bitmaps, codes_pair_multi, lookup_roundtrip,
    codes_pair_ab_kcodes, pair_ab_from_kcodes,
)


@pytest.fixture(scope="module")
def alp_clusters():
    return eliminate_null_params(cluster_ref_api(REF, 6, cutoffs=[7, 12, 20, 25])).profiles


def _random_clusters(k, wss, seed):
    """Cluster profiles of random references, one per windowsize."""
    rng = np.random.default_rng(seed)
    out = []
    for i, ws in enumerate(wss):
        refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(2 + i)]
        s = sum(kmer_count(x, k).astype(np.int64) for x in refs)
        out.append(RefProfile(mean_kfv=s / len(refs), sum_kfv=s, n_records=len(refs), windowsize=ws, consensus="A" * ws, k=k))
    return out, refs


def test_cpu_wrappers_launch_nothing(record, alp_clusters):
    codes, p = record
    for fn in WRAPPERS:
        fn.launches = 0
    eng, prep, nw, l0, kw = _bitmap_inputs(codes, p.sum_kfv, 6, p.windowsize, p.n_records, "cpu")
    thr = int(eng._thr_int(30.0))
    bm = fused_record_bitmaps(prep, eng.s_dev, thr=thr, l0=l0, nw=nw, **kw)
    assert int(bm.sum()) > 0
    assert eng.record_stream(codes, 30.0)[1]
    cl = ClusterScanEngine(alp_clusters, k=6, device="cpu")
    for fused_min in (1 << 16, 1):  # the split pass (K5), then K3 and K8
        cl.fused_min_windows = fused_min
        assert any(s for _d0, s in cl.record_streams(codes[:60_000], [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]))
    mixed = ClusterScanEngine([*alp_clusters, _prefix_profile()], k=6, device="cpu")  # K4 and K6
    assert any(s for _d0, s in mixed.record_streams(codes[:60_000], [35.0, 31.0, 38.0, 34.0, 27.0, 27.0, 1.14]))
    strobe = _strobe_engine(codes, "cpu")  # K4r
    assert strobe[0].record_stream(strobe[1], 30.0)[1]
    assert all(fn.launches == 0 for fn in WRAPPERS)


def test_wrappers_refuse_other_devices():
    tiles = torch.zeros((2, 10), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        match_counts(tiles, 4, 6)
    codes = torch.zeros(5000, dtype=torch.int8, device="meta")
    s = torch.zeros(16, dtype=torch.int32, device="meta")
    l0 = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_record_bitmaps(codes, s, thr=0, l0=l0, nw=100, k=2, ws=20, r=1, depth=4, t=512, block=512, n_tiles=1)
    with pytest.raises(ValueError, match="unsupported device"):
        codes_pair_multi(codes, 2, (20, 22), 100, 120, 4)
    s2 = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    l0s = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cluster_record_bitmaps(codes, s2, thrs=[0, 0], l0s=l0s, nws=[100, 98], k=2, specs=[(20, 1), (22, 1)], depth=4, t=512, block=512, n_tiles=1)
    with pytest.raises(ValueError, match="unsupported device"):
        lookup_roundtrip(s2, t=512, w_min=19, w_max=21)
    with pytest.raises(ValueError, match="unsupported device"):
        codes_pair_ab_kcodes(codes, 2, 19, 100, 120, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        pair_ab_from_kcodes(torch.zeros(200, dtype=torch.int32, device="meta"), 19, 100, 4)


def test_pair_depth_wrappers_check_their_inputs():
    codes = torch.zeros(500, dtype=torch.int8)
    with pytest.raises(ValueError, match="depth < w"):
        codes_pair_ab_kcodes(codes, 2, 19, 100, 120, 19)
    with pytest.raises(ValueError, match="int8, uint8 or int32"):
        codes_pair_ab_kcodes(codes.to(torch.int64), 2, 19, 100, 120, 4)
    with pytest.raises(ValueError, match="K codes"):
        pair_ab_from_kcodes(torch.zeros(110, dtype=torch.int32), 19, 100, 4)


@pytest.mark.cuda
def test_k1_matches_twin_on_card(record, cuda_device):
    codes, p = record
    eng, prep, nw, l0, kw = _bitmap_inputs(codes, p.sum_kfv, 6, p.windowsize, p.n_records, cuda_device)
    for thr in (int(eng._thr_int(30.0)), int(eng._thr_int(45.0))):
        before = fused_record_bitmaps.launches
        before3 = fused_cluster_record_bitmaps.launches
        got = fused_record_bitmaps(prep, eng.s_dev, thr=thr, l0=l0, nw=nw, **kw)
        torch.cuda.synchronize()
        assert fused_record_bitmaps.launches == before + 2
        assert fused_cluster_record_bitmaps.launches == before3  # K1 runs K3's kernel, counted as K1
        want = fused_record_bitmaps_plain(prep, eng.s_dev, thr=thr, l0=l0, nw=nw, **kw)
        assert torch.equal(got, want)
        assert int(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 8, 10])
def test_k1_table_placements_on_card(k, cuda_device):
    """k=7: the 64 KB table in opt-in shared memory; k=8: a 256 KB table,
    read through the read-only cache; k=10: the 4 MB table of the big-k
    row, through the read-only cache too."""
    rng = np.random.default_rng(k)
    ws, r = 120, 6
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    s = sum(kmer_count(x, k).astype(np.int64) for x in refs)
    codes = rng.integers(0, 4, 100_000, dtype=np.int8)
    for pos in range(1_000, 99_000, 7_000):
        codes[pos : pos + ws] = refs[pos % r]
    eng, prep, nw, l0, kw = _bitmap_inputs(codes, s, k, ws, r, cuda_device)
    bounds = tscan.scan_window_lower_bounds(prep[: nw + ws - 1], eng.s_dev, k, ws, r, eng.bound_depth)
    thr = int(torch.quantile(bounds.double(), 0.01))
    got = fused_record_bitmaps(prep, eng.s_dev, thr=thr, l0=l0, nw=nw, **kw)
    want = fused_record_bitmaps_plain(prep, eng.s_dev, thr=thr, l0=l0, nw=nw, **kw)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.cuda
def test_k2_matches_twin_on_card(record, cuda_device):
    codes, p = record
    k, ws, r = 6, p.windowsize, p.n_records
    w = ws - k + 1
    dev_codes = torch.from_numpy(codes).to(cuda_device)
    s = torch.from_numpy(p.sum_kfv.astype(np.int32)).to(cuda_device)
    # region rows: contiguous rows of t + w codes
    starts = torch.arange(0, 256 * 1024, 1024, device=cuda_device)
    rows = dev_codes[starts[:, None] + torch.arange(1024 + ws - 1, device=cuda_device)[None, :]]
    tiles = torch.nn.functional.pad(tscan.rolling_kmer_codes(rows, k), (0, 1))
    before = match_counts.launches
    got = match_counts(tiles, w, 1024)
    torch.cuda.synchronize()
    assert match_counts.launches == before + 1
    assert torch.equal(got, _match_counts_plain(tiles, w, 1024))
    # whole record: overlapping strided rows, ragged last tile
    got = scan_window_distances_kernel(dev_codes, s, k, ws, r)
    assert torch.equal(got, tscan.scan_window_distances(dev_codes, s, k, ws, r))


def _edge_kcodes(n: int, k: int, seed: int, run: tuple | None, device) -> torch.Tensor:
    """int32 K codes of a seeded record with a low-complexity quarter and
    optionally a run of one code, on ``device``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n + k - 1, dtype=np.int8)
    q = n // 4
    codes[q : 2 * q] = np.tile(rng.integers(0, 4, 7, dtype=np.int8), -(-q // 7))[:q]
    kc = tscan.rolling_kmer_codes(torch.from_numpy(codes), k)
    if run is not None:
        kc[run[0] : run[1]] = kc[run[0]]
    return kc.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,w,t,n_rows,stride,run",
    [
        (6, 284, 1000, 5, None, (30, 700)),  # t off a multiple of 16; a run longer than w
        (6, 284, 4097, 3, None, None),  # three tiles a row, the last of one position
        (6, 284, 2048, 40, 2048, (5_000, 5_400)),  # overlapping rows of a whole record
        (6, 284, 17, 9, None, None),
        (6, 17, 333, 4, 100, (40, 90)),  # depth 16: the small route
        (6, 18, 333, 4, None, None),  # depth 17: the streaming route
        (6, 1, 64, 3, None, None),  # depth 0
        (10, 120, 1024, 6, 1024, (500, 700)),  # k = 10: codes past 16 bits
    ],
)
def test_k2_routes_match_twin_on_card(cuda_device, k, w, t, n_rows, stride, run):
    """K2's register-blocked routine at its edges against the plain twin."""
    stride = t + w if stride is None else stride
    flat = _edge_kcodes((n_rows - 1) * stride + t + w, k, t + w, run, cuda_device)
    tiles = flat.as_strided((n_rows, t + w), (stride, 1))
    before = match_counts.launches
    got = match_counts(tiles, w, t)
    torch.cuda.synchronize()
    assert match_counts.launches == before + 1
    assert torch.equal(got, _match_counts_plain(tiles, w, t))
    if run is not None and run[1] - run[0] > w:
        assert int(got.abs().max()) == w


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,w,depth,nt,run,offset",
    [
        (6, 284, 1, 5_000 - 3, None, 0),
        (6, 15, 14, 4_100 - 5, (900, 1_000), 0),
        (6, 284, 16, 2 * 2048 + 17, (100, 600), 0),
        (6, 284, 16, 2 * 2048 + 17, (100, 600), 1),  # K codes off a 16-byte boundary
        (6, 284, 17, 3_001, (100, 600), 0),
        (6, 284, 283, 2_048 + 1, (700, 1_200), 0),
        (6, 284, 283, 2_048 + 1, (700, 1_200), 3),
        (10, 284, 16, 4_111, None, 0),
        (10, 120, 119, 2_500, (50, 400), 0),
    ],
)
def test_k6_routes_match_twin_on_card(cuda_device, k, w, depth, nt, run, offset):
    """K6's two routes at depths 1, 14, 16, 17 and w - 1, nt off a multiple
    of 16 and of the tile, runs of one code longer than w, k = 10, and K
    codes that do not start on a 16-byte boundary."""
    kc = _edge_kcodes(nt + w + 29 + offset, k, depth + nt, run, cuda_device)[offset:]
    before = pair_ab_from_kcodes.launches
    ab = pair_ab_from_kcodes(kc, w, nt, depth)
    torch.cuda.synchronize()
    assert pair_ab_from_kcodes.launches == before + 1
    assert torch.equal(ab, tscan._pair_ab(kc, w, nt, depth))
    if run is not None:
        assert int(ab.abs().max()) == depth


#: the widest window of K4's and K6's register-blocked route at their
#: 2048-position tile on an H100: the tile's padded K codes (16 + 2048 + w,
#: one pad word per 16) fill the 227 KB of shared memory a block may take
_PAIR_WIDEST_W = 52_628


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [16, 300])
def test_k4_and_k6_widest_window_on_card(cuda_device, depth):
    """K4 (k = 6, K codes built from the codes) and K6 at the widest window
    their tile allows match their twins; one code wider is refused, and the
    refusal does not leak into the next launch."""
    w, nt = _PAIR_WIDEST_W, 2 * 2048 + 5
    rng = np.random.default_rng(depth)
    codes = torch.from_numpy(rng.integers(0, 4, nt + w + 9, dtype=np.int8)).to(cuda_device)
    codes[1_000:1_400] = 2  # a run of one code: counts up to depth
    ab, kc = codes_pair_ab_kcodes(codes, 6, w, nt, nt + w, depth)
    ab_p, kc_p = _codes_pair_ab_kcodes_plain(codes, 6, w, nt, nt + w, depth)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p)
    assert int(ab.abs().max()) == depth
    assert torch.equal(pair_ab_from_kcodes(kc, w, nt, depth), ab_p)
    with pytest.raises(RuntimeError, match="CUDA error"):
        codes_pair_ab_kcodes(codes, 6, w + 1, nt, nt, depth)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pair_ab_from_kcodes(kc, w + 1, nt - 1, depth)
    assert torch.equal(pair_ab_from_kcodes(kc, w, nt, depth), ab_p)
    assert torch.equal(codes_pair_ab_kcodes(codes, 6, w, nt, nt + w, depth)[0], ab_p)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(record, cuda_device):
    codes, p = record
    kw = dict(k=6, ws=p.windowsize, r=p.n_records)
    on_card = tscan.ScanEngine(p.sum_kfv, device=cuda_device, **kw)
    on_cpu = tscan.ScanEngine(p.sum_kfv, device="cpu", **kw)
    for thr in (30.0, 40.0):
        assert on_card.record_stream(codes, thr) == on_cpu.record_stream(codes, thr)
    a = on_card.record_stream(codes, 30.0, collect_dists=True)
    b = on_cpu.record_stream(codes, 30.0, collect_dists=True)
    assert a[:2] == b[:2]
    np.testing.assert_array_equal(a[2], b[2])


def _k3_inputs(profiles, k, codes, thrs, device, bound_depth=16):
    eng = ClusterScanEngine(profiles, k=k, device=device, bound_depth=bound_depth)
    prep = eng.prepare_codes(codes)
    nws = [codes.shape[0] - ws + 1 for ws, _r in eng.specs]
    thr_ints = [int(e._thr_int(x)) for e, x in zip(eng.engines, thrs)]
    l0s = torch.stack([
        tscan._first_window_l0(prep, e.s_dev, k=k, ws=e.ws, r=e.r, depth=eng.groups[0][1]) for e in eng.engines
    ])
    kw = dict(k=k, specs=eng.specs, depth=eng.groups[0][1], t=eng.fused_t, block=eng.block, n_tiles=-(-max(nws) // eng.fused_t))
    return eng, prep, nws, thr_ints, l0s, kw


@pytest.mark.cuda
def test_k3_and_k8_tables_in_shared_memory_on_card(record, alp_clusters, cuda_device):
    """k = 6, the six Alp_V clusters: 96 KB of tables in shared memory."""
    codes, _p = record
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    eng, prep, nws, thr_ints, l0s, kw = _k3_inputs(alp_clusters, 6, codes, thrs, cuda_device)
    widths = [ws - 5 for ws, _r in eng.specs]
    assert cluster_tables_in_smem(6, 6, eng.fused_t, min(widths), max(widths))
    before = fused_cluster_record_bitmaps.launches
    got = fused_cluster_record_bitmaps(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw)
    torch.cuda.synchronize()
    assert fused_cluster_record_bitmaps.launches == before + 2
    assert torch.equal(got, fused_cluster_record_bitmaps_plain(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw))
    assert all(int(got[c].sum()) > 0 for c in range(6))
    back = lookup_roundtrip(eng.s_stack, t=eng.fused_t, w_min=min(widths), w_max=max(widths))
    assert torch.equal(back, eng.s_stack) and torch.equal(_lookup_roundtrip_plain(eng.s_stack), eng.s_stack)


@pytest.mark.cuda
def test_k3_and_k8_tables_through_ldg_on_card(cuda_device):
    """k = 7, six clusters: 384 KB of tables, read through __ldg."""
    k, wss = 7, [120, 120, 121, 122, 123, 123]
    profiles, refs = _random_clusters(k, wss, seed=7)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 150_000, dtype=np.int8)
    for pos in range(1_000, 149_000, 5_000):
        codes[pos : pos + 120] = refs[pos % len(refs)][:120]
    eng, prep, nws, thr_ints, l0s, kw = _k3_inputs(profiles, k, codes, [0.0] * 6, cuda_device)
    widths = [ws - k + 1 for ws in wss]
    assert not cluster_tables_in_smem(6, k, eng.fused_t, min(widths), max(widths))
    bounds = tscan.scan_window_lower_bounds(prep[: nws[0] + wss[0] - 1], eng.s_stack[0], k, wss[0], eng.specs[0][1], eng.groups[0][1])
    thr_ints = [int(torch.quantile(bounds.double(), 0.01))] * 6
    got = fused_cluster_record_bitmaps(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw)
    assert torch.equal(got, fused_cluster_record_bitmaps_plain(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw))
    assert 0 < int(got.sum()) < got.numel()
    back = lookup_roundtrip(eng.s_stack, t=eng.fused_t, w_min=min(widths), w_max=max(widths))
    assert torch.equal(back, eng.s_stack)


#: (cluster windowsizes or "alp", record length or "ragged", thresholds, tile
#: t) of the shapes where persistent blocks and register tiles could break
K3_SHAPES = {
    "fewer_tiles_than_grid": ("alp", 70_000, "quantile", 4096),
    "ragged_last_tile": ((120, 300), "ragged", "quantile", 4096),
    "one_cluster": ((289,), 300_000, "quantile", 4096),
    "max_clusters_ldg": (tuple(range(100, 420, 10)), 300_000, "quantile", 4096),
    "wide_widths_odd_m": ((120, 150, 200, 250, 300), 300_000, "quantile", 4096),
    "short_windows_depth_14": ((20, 21), 300_000, "quantile", 4096),
    "every_block": ("alp", 300_000, "all", 4096),
    "no_block": ("alp", 300_000, "none", 4096),
    "two_rounds_t8192": ("alp", 300_000, "quantile", 8192),
    "short_tile_t512": ((120, 300), 100_000, "quantile", 512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_SHAPES))
def test_k3_and_k8_persistent_shapes_on_card(case, alp_clusters, cuda_device):
    """K3 and K8 against their twins at the shapes of K3's persistent,
    register-tiled design: fewer tiles than the grid; a tile count no
    multiple of the grid with a partial last tile that masks only one
    cluster's tail (the other ends a tile earlier); one cluster; 32 (the
    __ldg route at k = 6); five clusters (an odd count: pass 2 takes two
    per barrier) of widths 120-300 at depth 16; windows of 15 and 16 K
    codes at depth 14 (the plain pair counts, not the 16-bit ones);
    thresholds that flag every block up to nw, and none; tiles of 8192
    windows (two rounds of a block, tables through __ldg) and of 512 (one
    round, most warps idle).  K3 launches twice, on a grid of at most one
    block per tile and per resident slot."""
    from kmergma_tpu_torch.ops.scan_cluster_fused import cluster_launch_shape

    wss, n, thr_mode, t = K3_SHAPES[case]
    k = 6
    profiles, refs = (alp_clusters, None) if wss == "alp" else _random_clusters(k, wss, seed=len(wss))
    widths = [p.windowsize - k + 1 for p in profiles]
    m = len(profiles)
    if n == "ragged":
        # the last tile holds 100 windows of the shortest cluster; the
        # longest one (180 windows fewer) ends inside the tile before
        full = cluster_launch_shape(m, k, t, min(widths), max(widths), 1 << 20)
        n_tiles = full["grid"] + full["grid"] // 3 + 1
        n = (n_tiles - 1) * t + 100 + min(p.windowsize for p in profiles) - 1
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    genes = refs if refs is not None else [rec.codes for rec in as_records(REF)]
    for j, pos in enumerate(range(2_000, n - 2_000, 9_000)):
        codes[pos : pos + genes[j % len(genes)].shape[0]] = genes[j % len(genes)]
    eng, prep, nws, _thr, l0s, kw = _k3_inputs(profiles, k, codes, [0.0] * m, cuda_device)
    kw = dict(kw, t=t, n_tiles=-(-max(nws) // t))
    need = kw["n_tiles"] * t + tscan._k1_halo(max(widths))
    prep = torch.cat([prep, prep.new_zeros(max(0, need - prep.shape[0]))])
    if thr_mode == "quantile":
        thr_ints = [
            int(torch.quantile(tscan.scan_window_lower_bounds(
                prep[: nws[c] + ws - 1], eng.s_stack[c], k, ws, r, kw["depth"]).double(), 0.02))
            for c, (ws, r) in enumerate(eng.specs)
        ]
    else:
        thr_ints = [2**31 - 1 if thr_mode == "all" else -(2**31)] * m
    in_smem = cluster_tables_in_smem(m, k, t, min(widths), max(widths))
    assert in_smem if m <= 6 and t <= 4096 else not in_smem  # 32 tables, or a t = 8192 tile: __ldg
    before = fused_cluster_record_bitmaps.launches
    got = fused_cluster_record_bitmaps(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw)
    torch.cuda.synchronize()
    assert fused_cluster_record_bitmaps.launches == before + 2
    want = fused_cluster_record_bitmaps_plain(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw)
    assert torch.equal(got, want)
    live = [-(-nw // eng.block) for nw in nws]  # blocks holding a window below nw
    if thr_mode == "all":
        assert [int(got[c].sum()) for c in range(m)] == live
    elif thr_mode == "none":
        assert int(got.sum()) == 0
    else:
        assert 0 < int(got.sum()) < sum(live)
    if case == "ragged_last_tile":
        assert kw["n_tiles"] % full["grid"] and live[0] != live[1]
    for emit in (False, True):
        shape = cluster_launch_shape(m, k, t, min(widths), max(widths), kw["n_tiles"], emit=emit)
        assert shape["grid"] == min(kw["n_tiles"], shape["sms"] * shape["blocks_per_sm"])
    back = lookup_roundtrip(eng.s_stack, t=t, w_min=min(widths), w_max=max(widths))
    assert torch.equal(back, eng.s_stack)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nt", [(60_000, 59_999), (300_000, 262_143)])
def test_k5_matches_twin_on_card(record, cuda_device, n, nt):
    codes, _p = record
    dev_codes = torch.from_numpy(codes[:n]).to(cuda_device)
    ws_tuple = (288, 289, 290)
    nkc = nt + 290 - 6
    before = codes_pair_multi.launches
    ab, kc = codes_pair_multi(dev_codes, 6, ws_tuple, nt, nkc, 16)
    torch.cuda.synchronize()
    assert codes_pair_multi.launches == before + 1
    ab_p, kc_p = _codes_pair_multi_plain(dev_codes, 6, ws_tuple, nt, nkc, 16)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p)
    assert int(ab.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_routes_match_twin_on_card(cuda_device, case):
    """K5's once-counted route at its edges (``tests/_k5_cases.py``)
    against the plain twin, one launch a call."""
    k, ws_tuple, depth, codes, nt, nkc, offset = k5_case(case)
    buf = torch.zeros(codes.shape[0] + offset, dtype=torch.int8)
    buf[offset:] = torch.from_numpy(codes)
    dev_codes = buf.to(cuda_device)[offset:]
    before = codes_pair_multi.launches
    ab, kc = codes_pair_multi(dev_codes, k, ws_tuple, nt, nkc, depth)
    torch.cuda.synchronize()
    assert codes_pair_multi.launches == before + 1
    assert ab.shape == (len(ws_tuple), nt) and kc.shape == (nkc,)
    ab_p, kc_p = _codes_pair_multi_plain(dev_codes, k, ws_tuple, nt, nkc, depth)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p)
    assert int(ab.abs().sum()) > 0 or depth == 0


@pytest.mark.cuda
def test_cluster_engine_on_card_matches_cpu(record, alp_clusters, cuda_device):
    codes, _p = record
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    for fused_min in (1 << 16, 1 << 30, 1):  # K3 (300 kb), the split pass, K3 again
        on_card = ClusterScanEngine(alp_clusters, k=6, device=cuda_device)
        on_cpu = ClusterScanEngine(alp_clusters, k=6, device="cpu")
        on_card.fused_min_windows = on_cpu.fused_min_windows = fused_min
        assert on_card.record_streams(codes, thrs) == on_cpu.record_streams(codes, thrs)
        short = codes[:50_000]
        assert on_card.record_streams(short, thrs) == on_cpu.record_streams(short, thrs)


def _prefix_profile():
    """The Alp_V genes' 20 bp prefixes at k = 6: ws 20, pair depth 14."""
    return gen_ref_ws_cons([FastaRecord(rec.description, rec.seq[:20]) for rec in as_records(REF)], 6)


def _strobe_engine(codes, device, s=2):
    """(span engine, strobe codes) of a record for the Alp_V strobe profile."""
    p = gen_strobe_ref_ws_cons(REF, s=s, w_min=3, w_max=5 if s == 2 else 6)
    sc = strobe_2_mer_codes(codes, p.s, p.w_min, p.w_max, p.q)
    w = p.windowsize - p.k
    n_steps = codes.shape[0] - p.windowsize - 1
    return StrobeSpanEngine(p, int(sc[w]), device=device), sc[: n_steps + w]


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,depth", [(6, 284, 16), (6, 15, 14), (6, 284, 283), (1, 40, 1)])
def test_k4_matches_twin_on_card(record, cuda_device, k, w, depth):
    codes, _p = record
    dev_codes = torch.from_numpy(codes).to(cuda_device)
    nt, nkc = codes.shape[0] - w - k, codes.shape[0] - k + 1
    before = codes_pair_ab_kcodes.launches
    ab, kc = codes_pair_ab_kcodes(dev_codes, k, w, nt, nkc, depth)
    torch.cuda.synchronize()
    assert codes_pair_ab_kcodes.launches == before + 1
    ab_p, kc_p = _codes_pair_ab_kcodes_plain(dev_codes, k, w, nt, nkc, depth)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p)
    assert int(ab.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3])
def test_k4r_matches_twin_on_card(record, cuda_device, s):
    """The strobe engine's exact pass: k = 1, depth ws - k, uint8 strobe
    codes (many >= 128) at s = 2, int32 codes up to 4095 at s = 3."""
    codes, _p = record
    eng, sc = _strobe_engine(codes, cuda_device, s=s)
    prep = eng.prepare_codes(sc)
    assert prep.dtype == (torch.uint8 if s == 2 else torch.int32)
    assert int(prep.max()) >= (128 if s == 2 else 256)
    w = eng.ws
    nw = sc.shape[0] - w + 1
    args = (prep, 1, w, nw - 1, nw + w - 1, w - 1)
    ab, kc = codes_pair_ab_kcodes(*args)
    ab_p, kc_p = _codes_pair_ab_kcodes_plain(*args)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p)
    np.testing.assert_array_equal(kc.cpu().numpy(), sc[: nw + w - 1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,nt,nkc,offset",
    [
        (3 * 2048 + 400, 3 * 2048 - 283, 3 * 2048 + 1, 0),  # tile edges: n_tiles * 2048 just above nkc
        (3 * 2048 + 400, 2048, 2048, 0),  # nt and nkc on a tile edge
        (3 * 2048 + 400, 2047, 2049, 3),  # one off either side; codes 3 bytes off a 16-byte boundary
        (40, 5, 15, 1),  # fewer positions than one chunk
        (5_000_000, 5_000_000 - 283 - 17, 5_000_000 - 1, 0),  # many positions a thread, ragged last chunk
        (5_000_000, 4_999_000, 4_999_701, 13),
    ],
)
def test_k4r_sliding_histogram_matches_twin_on_card(cuda_device, n, nt, nkc, offset):
    """K4r's sliding-histogram route (uint8 codes, k = 1, depth w - 1) at
    segment, chunk and tile edges, on codes that do not start on a 16-byte
    boundary, and with a run of one code long enough for a count of w - 1."""
    w = 283
    rng = np.random.default_rng(n + offset)
    codes = rng.integers(0, 256, n + offset + w + 2048).astype(np.uint8)
    codes[offset + 100 : offset + 100 + 2 * w] = 9
    dev = torch.from_numpy(codes).to(cuda_device)[offset:]
    before = codes_pair_ab_kcodes.launches
    ab, kc = codes_pair_ab_kcodes(dev, 1, w, nt, nkc, w - 1)
    torch.cuda.synchronize()
    assert codes_pair_ab_kcodes.launches == before + 1
    ab_p, kc_p = _codes_pair_ab_kcodes_plain(dev, 1, w, nt, nkc, w - 1)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p)
    if nt > 100 + w:
        assert int(ab.abs().max()) == w - 1


@pytest.mark.cuda
def test_k1_and_k3_count_their_own_launches(record, alp_clusters, cuda_device):
    """K1 launches K3's kernel but counts on its own wrapper: a K1 call adds
    2 to K1's count and leaves K3's, a K3 call the other way round."""
    codes, p = record
    eng, prep, nw, l0, kw = _bitmap_inputs(codes, p.sum_kfv, 6, p.windowsize, p.n_records, cuda_device)
    k1, k3 = fused_record_bitmaps.launches, fused_cluster_record_bitmaps.launches
    fused_record_bitmaps(prep, eng.s_dev, thr=int(eng._thr_int(30.0)), l0=l0, nw=nw, **kw)
    assert (fused_record_bitmaps.launches, fused_cluster_record_bitmaps.launches) == (k1 + 2, k3)
    cl = ClusterScanEngine(alp_clusters, k=6, device=cuda_device)
    cl.fused_min_windows = 1
    cl.record_streams(codes, [35.0, 31.0, 38.0, 34.0, 27.0, 27.0])
    assert fused_record_bitmaps.launches == k1 + 2 and fused_cluster_record_bitmaps.launches == k3 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("w,depth", [(284, 16), (15, 14), (284, 283), (2, 1)])
def test_k6_matches_twin_on_card(record, cuda_device, w, depth):
    codes, _p = record
    kc = tscan.rolling_kmer_codes(torch.from_numpy(codes).to(cuda_device), 6)
    nt = kc.shape[0] - w - 77  # ragged last tile; K codes past nt + w unread
    before = pair_ab_from_kcodes.launches
    ab = pair_ab_from_kcodes(kc, w, nt, depth)
    torch.cuda.synchronize()
    assert pair_ab_from_kcodes.launches == before + 1
    assert torch.equal(ab, tscan._pair_ab(kc, w, nt, depth))
    assert torch.equal(ab, pair_ab_from_kcodes(kc[: nt + w].clone(), w, nt, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [270, 283])
def test_depth_route_k4_and_k6_match_twins_on_card(record, alp_clusters, cuda_device, depth):
    """The depth route at 270 and at the Alp_V profile's full depth 283:
    K4 at the single-profile engine's shapes (its padded codes, every
    window) and K6 on those K codes (a ragged last tile), one launch each
    and bit-identical to their twins; the single-profile and cluster
    engines at that depth (283: exact mode, and K4 and K6 for the mixed
    cluster depths) give the CPU's streams, with one K4 launch a record."""
    codes, p = record
    k, ws = 6, p.windowsize
    w = ws - k + 1
    eng = tscan.ScanEngine(p.sum_kfv, k=k, ws=ws, r=p.n_records, device=cuda_device, bound_depth=depth)
    assert not eng.on_k1
    prep, nw = eng.prepare_codes(codes), codes.shape[0] - ws + 1
    args = (prep, k, w, nw - 1, nw + w - 1, depth)
    before = codes_pair_ab_kcodes.launches
    ab, kc = codes_pair_ab_kcodes(*args)
    torch.cuda.synchronize()
    assert codes_pair_ab_kcodes.launches == before + 1
    ab_p, kc_p = _codes_pair_ab_kcodes_plain(*args)
    assert torch.equal(ab, ab_p) and torch.equal(kc, kc_p) and int(ab.abs().sum()) > 0
    nt = nw - 1 - 333
    before = pair_ab_from_kcodes.launches
    ab6 = pair_ab_from_kcodes(kc[: nt + w], w, nt, depth)
    torch.cuda.synchronize()
    assert pair_ab_from_kcodes.launches == before + 1
    assert torch.equal(ab6, tscan._pair_ab(kc, w, nt, depth))
    cpu = tscan.ScanEngine(p.sum_kfv, k=k, ws=ws, r=p.n_records, device="cpu", bound_depth=depth)
    before = codes_pair_ab_kcodes.launches
    assert eng.record_stream(codes, 30.0) == cpu.record_stream(codes, 30.0)
    assert codes_pair_ab_kcodes.launches == before + 1
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    card = ClusterScanEngine(alp_clusters, k=6, device=cuda_device, bound_depth=depth)
    before = (codes_pair_ab_kcodes.launches, pair_ab_from_kcodes.launches, fused_cluster_record_bitmaps.launches)
    got = card.record_streams(codes, thrs)
    assert card.shared_depth is None and (
        codes_pair_ab_kcodes.launches, pair_ab_from_kcodes.launches, fused_cluster_record_bitmaps.launches
    ) == (before[0] + 1, before[1] + len(card.groups) - 1, before[2])
    assert got == ClusterScanEngine(alp_clusters, k=6, device="cpu", bound_depth=depth).record_streams(codes, thrs)


@pytest.mark.cuda
def test_k3_at_depth_64_matches_twin_on_card(record, alp_clusters, cuda_device):
    """K3 at depth 64 for the six Alp_V clusters (the cluster engine's
    bound_depth=64, a depth K3's byte counts take): one call (two
    launches), bit-identical to its twin; the engine's streams on both
    routes equal the CPU's."""
    codes, _p = record
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    eng, prep, nws, thr_ints, l0s, kw = _k3_inputs(alp_clusters, 6, codes, thrs, cuda_device, bound_depth=64)
    assert eng.shared_depth == kw["depth"] == 64
    before = fused_cluster_record_bitmaps.launches
    got = fused_cluster_record_bitmaps(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw)
    torch.cuda.synchronize()
    assert fused_cluster_record_bitmaps.launches == before + 2  # totals, then the bitmap
    assert torch.equal(got, fused_cluster_record_bitmaps_plain(prep, eng.s_stack, thrs=thr_ints, l0s=l0s, nws=nws, **kw))
    assert all(int(got[c].sum()) > 0 for c in range(6))
    cpu = ClusterScanEngine(alp_clusters, k=6, device="cpu", bound_depth=64)
    for fused_min in (1, 1 << 30):  # K3, then the split pass (K5 at depth 64)
        eng.fused_min_windows = cpu.fused_min_windows = fused_min
        assert eng.record_streams(codes, thrs) == cpu.record_streams(codes, thrs)


@pytest.mark.cuda
def test_strobe_and_mixed_depth_engines_on_card_match_cpu(record, alp_clusters, cuda_device):
    codes, _p = record
    on_card, sc = _strobe_engine(codes, cuda_device)
    on_cpu, _sc = _strobe_engine(codes, "cpu")
    for thr in (30.0, 33.5):
        assert on_card.record_stream(sc, thr) == on_cpu.record_stream(sc, thr)
    profiles = [*alp_clusters, _prefix_profile()]
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0, 1.14]
    card = ClusterScanEngine(profiles, k=6, device=cuda_device)
    cpu = ClusterScanEngine(profiles, k=6, device="cpu")
    assert card.record_streams(codes, thrs) == cpu.record_streams(codes, thrs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, (1 << 20) + 12345, 64_000_003])
@pytest.mark.parametrize("seed", [42, 2**31 + 5])
def test_k7_matches_twin_on_card(cuda_device, n, seed):
    """K7: the tail alone, one 16-code store, a store and a tail, and sizes
    over many grid-stride rounds, bit-identical to the plain twin."""
    from kmergma_tpu_torch.bench import hash_genome, hash_genome_plain

    before = hash_genome.launches
    got = hash_genome(n, seed, cuda_device)
    torch.cuda.synchronize()
    assert hash_genome.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (n,)
    assert torch.equal(got, hash_genome_plain(n, seed, cuda_device))


@pytest.mark.cuda
def test_device_tensor_inputs_on_card_match_host_inputs(record, alp_clusters, cuda_device):
    """Records already on the card: the cluster engine's streams, and the
    strobe miner's hits through genome_dev= / engine_cache=, equal those of
    the same calls on host codes."""
    from kmergma_tpu_torch.models.strobe_miner import strobe_mine_genome

    codes, _p = record
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    eng = ClusterScanEngine(alp_clusters, k=6, device=cuda_device)
    dev_codes = torch.from_numpy(codes).to(cuda_device)
    assert eng.record_streams(dev_codes, thrs) == eng.record_streams(codes, thrs)
    p = gen_strobe_ref_ws_cons(REF)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    rec = FastaRecord("r", letters[codes].tobytes())
    cache = {}
    for _ in range(2):
        got = strobe_mine_genome([rec], p, thr=30.0, genome_dev=[dev_codes], engine_cache=cache, device=cuda_device)
    want = strobe_mine_genome([rec], p, thr=30.0, device=cuda_device)
    assert [h.description for h in got.hits] == [h.description for h in want.hits] and len(cache) == 1


@pytest.mark.cuda
def test_exact_match_engine_on_card_matches_host(record, cuda_device):
    from kmergma_tpu_torch.ops.exact_match import match_starts_engine, match_starts_np

    codes, _p = record
    sub = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes()
    for q in (sub[1000:1030], sub[5000:5003], sub[7000:7016], sub[9000:9040], b"ACGTN"):
        assert match_starts_engine(sub, q, device=cuda_device).tolist() == match_starts_np(sub, q).tolist()


def _r1_args(profiles, device):
    return (
        [torch.from_numpy(p["d"]).to(device) for p in profiles],
        [torch.from_numpy(p["starts"]).to(device) for p in profiles],
        [torch.tensor(p["nvr"], dtype=torch.int32, device=device) for p in profiles],
        [p["thr"] for p in profiles], [p["nw"] for p in profiles], [p["mi"] for p in profiles],
        [p["R"] for p in profiles],
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rspan", [1024, 64, 40])
def test_r1_matches_twin_on_card(cuda_device, rspan):
    """R1 on the edge cases of ``tests/_r1_cases.py``, each one call and
    all single-profile cases in one call together, equal to its plain twin
    (the old torch chain); one launch count a call."""
    cases = [r1_case(name, rspan=rspan, seed=3) for name in R1_CASES]
    singles = [p for profiles in cases if len(profiles) == 1 for p in profiles]
    for profiles in cases + [singles]:
        run_reduce_multi.launches = run_reduce_multi.kernel_launches = 0
        got = run_reduce_multi(*_r1_args(profiles, cuda_device))
        torch.cuda.synchronize()
        assert run_reduce_multi.launches == 1 and run_reduce_multi.kernel_launches == 1
        assert torch.equal(got, _run_reduce_multi_plain(*_r1_args(profiles, cuda_device)))


@pytest.mark.cuda
def test_r1_past_one_launch_on_card(cuda_device):
    """More profiles than one launch's parameters hold (the 84-profile case
    eight times over, 672 profiles) take one launch for each 510 into the
    same output; calls of every size in a row on one stream reuse its
    status buffer, each under its own epoch.  The kernel launches are
    the C entry point's own count."""
    big = r1_case("m84", rspan=64, seed=6) * 8
    run_reduce_multi.launches = run_reduce_multi.kernel_launches = 0
    got = run_reduce_multi(*_r1_args(big, cuda_device))
    assert (run_reduce_multi.launches, run_reduce_multi.kernel_launches) == (1, 2)
    assert torch.equal(got, _run_reduce_multi_plain(*_r1_args(big, cuda_device)))
    for _ in range(3):
        for name in ("one_row", "m84", "runs_across_rows"):
            profiles = r1_case(name, rspan=64, seed=7)
            assert torch.equal(run_reduce_multi(*_r1_args(profiles, cuda_device)),
                               _run_reduce_multi_plain(*_r1_args(profiles, cuda_device)))


@pytest.mark.cuda
def test_r1_strided_inputs_on_card(cuda_device):
    """Distances and starts that are strided views give the twin's output.
    The wrapper makes each profile's contiguous copy; every copy lives
    until the launch is queued, so a later profile's copy of the same size
    never takes an earlier one's memory first."""
    for name in ("m6", "m33", "m84"):
        profiles = r1_case(name, rspan=64, seed=8)
        ds, starts, *rest = _r1_args(profiles, cuda_device)
        ds_t = [d.t().contiguous().t() for d in ds]  # column-major: not contiguous past one row
        starts_s = [torch.stack([s, s], dim=1)[:, 0] for s in starts]  # stride 2
        assert sum(not d.is_contiguous() for d in ds_t) >= 2 and sum(not s.is_contiguous() for s in starts_s) >= 2
        got = run_reduce_multi(ds_t, starts_s, *rest)
        assert torch.equal(got, _run_reduce_multi_plain(ds, starts, *rest))


@pytest.mark.cuda
def test_r1_counts_behind_a_spy(cuda_device, monkeypatch):
    """A spy standing in for ``run_reduce_multi`` in its module (as
    ``chip_smoke.py`` captures the planned passes' inputs) leaves the count
    on the wrapper: one a planned pass."""
    from kmergma_tpu_torch.ops import scan_kernels

    seen = []

    def spy(*args):
        seen.append(len(args[0]))
        return run_reduce_multi(*args)

    monkeypatch.setattr(scan_kernels, "run_reduce_multi", spy)
    p = gen_ref_ws_cons(REF, 6)
    eng = tscan.ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, device=cuda_device)
    codes = next(iter(as_records(REF))).codes
    run_reduce_multi.launches = 0
    eng.record_stream(np.concatenate([codes, codes, codes]), 30.0)
    assert seen == [1] and run_reduce_multi.launches == 1



def _many_clusters(m: int):
    """The Alp_V set in m clusters at k = 6 (cutoffs between the sorted
    distinct distances to the mean profile, as ``tests/test_torch_cluster.py``
    makes them) and the API's thresholds for them."""
    from kmergma_tpu_torch.ops.thresholds import estimate_optimal_thresholds

    d = np.unique(np.asarray(cluster_ref_api(REF, 6, get_dists=True).dists))
    mids = [float(x) for x in (d[1:] + d[:-1]) / 2]
    cut = mids if m == 84 else mids[::2][: m - 2]
    clusters = eliminate_null_params(cluster_ref_api(REF, 6, cutoffs=cut))
    assert len(clusters.profiles) == m
    return cut, clusters, estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [33, 84])
def test_many_clusters_engine_on_card_matches_cpu(record, cuda_device, m):
    """Past 32 clusters, both routes on the card give the CPU engine's
    streams; K3 launches twice for each group of 32 clusters, and R1 once a
    planned pass for all m."""
    codes, _p = record
    _cut, clusters, thrs = _many_clusters(m)
    for fused_min in (1 << 16, 1 << 30):  # K3 (300 kb), the split pass
        on_card = ClusterScanEngine(clusters.profiles, k=6, device=cuda_device)
        on_cpu = ClusterScanEngine(clusters.profiles, k=6, device="cpu")
        on_card.fused_min_windows = on_cpu.fused_min_windows = fused_min
        fused_cluster_record_bitmaps.launches = run_reduce_multi.launches = run_reduce_multi.kernel_launches = 0
        assert on_card.record_streams(codes, thrs) == on_cpu.record_streams(codes, thrs)
        assert fused_cluster_record_bitmaps.launches == (2 * -(-m // 32) if fused_min == 1 << 16 else 0)
        assert run_reduce_multi.launches >= 1 and run_reduce_multi.kernel_launches == run_reduce_multi.launches


@pytest.mark.cuda
def test_split_pass_past_32_windowsizes_on_card(cuda_device):
    """33 clusters at 33 windowsizes (k = 4): two K5 calls, two K3 calls,
    the streams of the CPU engine on both routes."""
    wss = list(range(40, 73))
    profiles, _refs = _random_clusters(4, wss, 33)
    rng = np.random.default_rng(33)
    codes = rng.integers(0, 4, 80_000, dtype=np.int8)
    thrs = [6.0] * len(wss)
    for fused_min in (1 << 30, 1):
        on_card = ClusterScanEngine(profiles, k=4, device=cuda_device)
        on_cpu = ClusterScanEngine(profiles, k=4, device="cpu")
        on_card.fused_min_windows = on_cpu.fused_min_windows = fused_min
        codes_pair_multi.launches = fused_cluster_record_bitmaps.launches = 0
        assert on_card.record_streams(codes, thrs) == on_cpu.record_streams(codes, thrs)
        assert (codes_pair_multi.launches, fused_cluster_record_bitmaps.launches) == ((2, 0) if fused_min > 1 else (0, 4))


@pytest.mark.cuda
def test_many_clusters_sharded_on_card_matches_cpu(record, cuda_device):
    """``ShardedClusterScanEngine`` at 35 clusters over two logical shards
    of the card, both routes, against the CPU engine."""
    from kmergma_tpu_torch.parallel.mesh import make_mesh
    from kmergma_tpu_torch.parallel.sharded_scan import ShardedClusterScanEngine

    codes, _p = record
    _cut, clusters, thrs = _many_clusters(35)
    want = ClusterScanEngine(clusters.profiles, k=6, device="cpu").record_streams(codes, thrs)
    for fused_min in (1 << 16, 1 << 30):
        eng = ShardedClusterScanEngine(clusters.profiles, k=6, mesh=make_mesh(devices=[cuda_device] * 2))
        eng.fused_min_windows = fused_min
        assert eng.record_streams(codes, thrs) == want


@pytest.mark.cuda
def test_many_clusters_api_and_resume_on_card(cuda_device, tmp_path, monkeypatch):
    """``find_genes_cluster_mode`` with 35 clusters on Loci.fasta on the
    card returns the CPU run's hits and loci, uninterrupted and killed on
    its second record then resumed."""
    import os

    import kmergma_tpu_torch as kt
    from kmergma_tpu_torch.ops import scan_cluster as tcluster

    genome = str(Path(REF).parent / "Loci.fasta")
    cut, _clusters, _thrs = _many_clusters(35)
    kw = dict(cluster_cutoffs=cut, verbose=False, do_return_hit_loci=True)

    def run(device, **extra):
        hits, loci = kt.find_genes_cluster_mode(genome, REF, device=device, **kw, **extra)
        return [(h.description, h.seq) for h in hits], loci

    want = run("cpu")
    assert want[0] and run(cuda_device) == want
    scanned = [0]
    real = tcluster.ClusterScanEngine.record_streams

    def dying(self, *a, **kwargs):
        scanned[0] += 1
        if scanned[0] == 2:
            raise KeyboardInterrupt("simulated kill")
        return real(self, *a, **kwargs)

    ckpt = str(tmp_path / "many.ckpt")
    with monkeypatch.context() as mp:
        mp.setattr(tcluster.ClusterScanEngine, "record_streams", dying)
        with pytest.raises(KeyboardInterrupt):
            run(cuda_device, checkpoint_path=ckpt)
    assert os.path.exists(ckpt)
    assert run(cuda_device, checkpoint_path=ckpt) == want and not os.path.exists(ckpt)
