"""The port's two-axis ("clusters" x "data") mesh and
``sharded_cluster_scan_step`` against the JAX package's, on the conftest's
8 virtual CPU devices and the port's logical CPU shards: the mesh shapes,
``make_tiles``, the step's six outputs (values, dtypes, shapes) on meshes
of 1 to 8 devices, the errors, K2 counted once a device for all its
profiles, the one-axis engines on a two-axis mesh, two gloo processes on a
hybrid mesh, and on the card the step over logical shards of cuda:0
against the CPU.  The step is integer arithmetic, so the bar is equality.

The file reaches the JAX package only through a fixture, so on a GPU host
without it the ``cuda`` test runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_two_axis.py
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kmergma_tpu_torch.ops import scan_kernels
from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
from kmergma_tpu_torch.ops.scan import (
    ScanEngine,
    _cumsum32,
    _rows_ab,
    _rows_d_from,
    _scan_rows_d,
    _sq_norm,
    _window_count_sq,
    profile_lookup,
    rolling_kmer_codes,
)
from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
from kmergma_tpu_torch.ops.scan_host import scan_window_distances_np_i64
from kmergma_tpu_torch.parallel import make_mesh, make_tiles, sharded_cluster_scan_step
from kmergma_tpu_torch.parallel.mesh import _cluster_ways
from kmergma_tpu_torch.parallel.sharded_scan import ShardedClusterScanEngine, ShardedScanEngine, _tile_candidates
from kmergma_tpu_torch.utils.fasta import as_records

from ._torch_multihost_worker import run_workers
from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data"
MESHES = [(1, 1), (1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's mesh and step."""
    jmesh = pytest.importorskip("kmergma_tpu.parallel.mesh")
    jscan = pytest.importorskip("kmergma_tpu.parallel.sharded_scan")
    return SimpleNamespace(make_mesh=jmesh.make_mesh, cluster_ways=jmesh._cluster_ways,
                           step=jscan.sharded_cluster_scan_step, make_tiles=jscan.make_tiles)


def _dryrun_case():
    """The JAX dryrun's inputs (``__graft_entry__.dryrun_multichip`` stage
    3): k 6, ws 64, r 4, tiles of 32 windows, cap 128, every window below."""
    rng = np.random.default_rng(0)
    k, ws, r, t = 6, 64, 4, 32
    codes = rng.integers(0, 4, t * 8 * 2 + ws - 1, dtype=np.int8)
    s = rng.integers(0, 8, (8, 4**k)).astype(np.int32)
    return dict(codes=codes, s=s, thr=np.full(8, 2**30, dtype=np.int32), k=k, ws=ws, r=r, t=t)


@pytest.fixture(scope="module")
def alp_case():
    """The Alp_V locus against four profiles, profile j summed over the
    reference records with index j mod 4 (21 each), ws 289, r 21, tiles
    of 512 windows; each profile twice, its thresholds the 2nd and the 5th
    percentile of its exact distances over the locus (eight rows, so that
    the clusters axis takes up to eight ways)."""
    refs = as_records(str(DATA / "Alp_V_ref.fasta"))
    s = np.stack([gen_ref_ws_cons(refs[j::4], 6).sum_kfv for j in range(4)]).astype(np.int32)
    codes = as_records(str(DATA / "Alp_V_locus.fasta"))[0].codes
    k, ws, r = 6, 289, 21
    d = [scan_window_distances_np_i64(codes, p, k, ws, r) for p in s]
    thr = np.array([np.percentile(x, q) for q in (2, 5) for x in d], dtype=np.int32)
    s = np.concatenate([s, s])
    return dict(codes=codes, s=s, thr=thr, k=k, ws=ws, r=r, t=512)


def _step_both(jx, case, nc: int, nd: int, cap: int):
    tiles, _ = make_tiles(case["codes"], case["t"], case["ws"], nd)
    kw = dict(k=case["k"], ws=case["ws"], r=case["r"], cap=cap)
    want = jx.step(tiles, case["s"], case["thr"], mesh=jx.make_mesh(nc * nd, n_clusters=nc), **kw)
    got = sharded_cluster_scan_step(tiles, case["s"], case["thr"], mesh=make_mesh(nc * nd, n_clusters=nc, device="cpu"),
                                    **kw)
    return [np.asarray(a) for a in want], got


def _assert_equal(want, got) -> None:
    assert len(got) == 6
    for a, b in zip(want, got):
        assert b.device == torch.device("cpu")
        b = b.numpy()
        assert (b.dtype, b.shape) == (a.dtype, a.shape)
        assert np.array_equal(a, b)


# --- the mesh ----------------------------------------------------------------


@pytest.mark.parametrize("n_clusters", range(1, 10))
def test_cluster_ways_match_jax(jx, n_clusters):
    assert [_cluster_ways(n_clusters, n) for n in range(1, 9)] == [jx.cluster_ways(n_clusters, n) for n in range(1, 9)]


@pytest.mark.parametrize("n_dev, n_clusters", [(8, 1), (8, 2), (8, 3), (8, 8), (4, 6), (6, 4)])
def test_mesh_shape_matches_jax(jx, n_dev, n_clusters):
    m = make_mesh(n_dev, n_clusters=n_clusters, device="cpu")
    assert m.shape == dict(jx.make_mesh(n_dev, n_clusters=n_clusters).shape)
    c, d = m.shape["clusters"], m.shape["data"]
    assert len(m.rows) == c and all(len(row) == d for row in m.rows) and m.local_data == m.rows[0]


@pytest.mark.parametrize("extra", [-5, 0, 7])
def test_make_tiles_matches_jax(jx, extra):
    """A record whose windows end below, at and above a tile multiple."""
    ws, t = 64, 32
    codes = np.random.default_rng(1).integers(0, 4, 5 * t + ws - 1 + extra, dtype=np.int8)
    for n_round in (1, 4):
        got, want = make_tiles(codes, t, ws, n_round), jx.make_tiles(codes, t, ws, n_round)
        assert got[1] == want[1] and got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])


# --- the step against the JAX package's ------------------------------------------


@pytest.mark.parametrize("nc, nd", MESHES)
def test_step_matches_jax_dryrun(jx, nc, nd):
    want, got = _step_both(jx, _dryrun_case(), nc, nd, cap=128)
    _assert_equal(want, got)
    assert (want[1] == 32).all()  # every window a candidate; the cap pads past t


@pytest.mark.parametrize("cap", [64, 600])
@pytest.mark.parametrize("nc, nd", MESHES)
def test_step_matches_jax_alp_v(jx, alp_case, nc, nd, cap):
    """cap 64 saturates in the tiles around the genes; 600 is past t."""
    want, got = _step_both(jx, alp_case, nc, nd, cap=cap)
    _assert_equal(want, got)
    assert (want[1] > 64).any() and (want[1] == 0).any()


def test_tile_candidates_order_and_padding():
    d = torch.tensor([[5, 1, 7, 1, 9, 9], [0, 9, 9, 9, 9, 0]], dtype=torch.int32)
    d_first, count, idx, vals, b0, b1 = _tile_candidates(d, torch.tensor(2, dtype=torch.int32), cap=8)
    assert d_first.tolist() == [5, 0] and count.tolist() == [4, 3]
    assert idx.tolist() == [[1, 2, 3, 4, 0, 0, 0, 0], [0, 1, 5, 0, 0, 0, 0, 0]]
    assert vals.tolist() == [[1, 7, 1, 9, 5, 5, 5, 5], [0, 9, 0, 0, 0, 0, 0, 0]]
    assert b0.tolist() == [False, True] and b1.tolist() == [False, True]
    assert [x.dtype for x in (count, idx, vals, b0)] == [torch.int32, torch.int32, torch.int32, torch.bool]


@pytest.mark.parametrize("what", ["profiles", "tiles"])
def test_step_raises_where_an_axis_does_not_divide(jx, what):
    case = _dryrun_case()
    tiles, _ = make_tiles(case["codes"], case["t"], case["ws"], 4)
    s, thr = case["s"], case["thr"]
    if what == "profiles":
        s, thr = s[:3], thr[:3]
    else:
        tiles = tiles[:7]
    kw = dict(k=case["k"], ws=case["ws"], r=case["r"], cap=16)
    with pytest.raises(ValueError, match="not evenly divisible"):
        jx.step(tiles, s, thr, mesh=jx.make_mesh(8, n_clusters=2), **kw)
    with pytest.raises(ValueError, match="do not split"):
        sharded_cluster_scan_step(tiles, s, thr, mesh=make_mesh(8, n_clusters=2, device="cpu"), **kw)


# --- K2 once a device, shared across its profiles ----------------------------------


@pytest.mark.parametrize("nc, nd", [(1, 1), (2, 4), (4, 2)])
def test_one_match_count_call_per_device(monkeypatch, alp_case, nc, nd):
    calls = []
    real = scan_kernels.match_counts

    def spy(tiles_k, w, t):
        calls.append(tiles_k.shape)
        return real(tiles_k, w, t)

    monkeypatch.setattr(scan_kernels, "match_counts", spy)
    tiles, _ = make_tiles(alp_case["codes"], 512, 289, nd)
    sharded_cluster_scan_step(tiles, alp_case["s"], alp_case["thr"], k=6, ws=289, r=21, cap=8,
                              mesh=make_mesh(nc * nd, n_clusters=nc, device="cpu"))
    assert calls == [(tiles.shape[0] // nd, 512 + 284)] * (nc * nd)


def _rows_d_before_split(kc, g, s2, k, ws, r):
    """``_rows_d_from`` as it was before its K2 counts were split out
    (each call counted them)."""
    n, m = kc.shape
    w = ws - k + 1
    rspan = m - w + 1
    c0_sq = _window_count_sq(kc[:, :w])
    g0 = g[:, :w].to(torch.int64).sum(dim=1)
    d0 = (r * r * c0_sq - 2 * r * g0 + s2).to(torch.int32)
    if rspan == 1:
        return d0[:, None]
    nt = rspan - 1
    kl = kc[:, :nt]
    kr = kc[:, w : w + nt]
    tiles = torch.nn.functional.pad(kc, (0, rspan + w - m))
    ab = scan_kernels.match_counts(tiles, w, rspan)[:, :nt]
    r2 = 2 * r * r
    delta = r2 * (kl != kr).to(torch.int32) + r2 * ab + (2 * r) * (g[:, :nt] - g[:, w : w + nt])
    return torch.cat([d0[:, None], d0[:, None] + _cumsum32(delta, dim=1)], dim=1)


@pytest.mark.parametrize("rspan", [1, 2, 300])
def test_rows_d_unchanged_by_the_split(alp_case, rspan):
    k, ws, r = 6, 289, 21
    starts = np.arange(0, 30_000, 2_999)
    rows = torch.from_numpy(np.stack([alp_case["codes"][s0 : s0 + rspan + ws - 1] for s0 in starts]))
    kc = rolling_kmer_codes(rows, k)
    ab = _rows_ab(kc, ws - k + 1)
    assert (ab is None) == (rspan == 1)
    for p in alp_case["s"]:
        s = torch.from_numpy(p)
        g = profile_lookup(kc, s)
        old = _rows_d_before_split(kc, g, _sq_norm(s), k, ws, r)
        assert torch.equal(_scan_rows_d(rows, s, k, ws, r), old)
        assert torch.equal(_rows_d_from(kc, g, _sq_norm(s), k, ws, r, ab=ab), old)
        want = np.stack([scan_window_distances_np_i64(row.numpy(), p, k, ws, r) for row in rows])
        assert np.array_equal(old.numpy(), want)


# --- the one-axis engines on a two-axis mesh ---------------------------------------


def test_one_axis_engines_on_a_two_axis_mesh(alp_case, ref_fasta):
    """The sharded engines read only the data axis: on a (2 x 2) mesh they
    give the streams of the (1 x 2) mesh and of one device."""
    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params

    two = make_mesh(4, n_clusters=2, device="cpu")
    one = make_mesh(2, device="cpu")
    assert two.shape == {"clusters": 2, "data": 2} and two.local_data == one.local_data
    codes = alp_case["codes"]
    p = gen_ref_ws_cons(ref_fasta, 6)
    want = ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, device="cpu").record_stream(codes, 8.5)[:2]
    assert len(want[1]) > 0
    for mesh in (two, one):
        eng = ShardedScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, mesh=mesh, chunk_windows=2048)
        assert eng.record_stream(codes, 8.5)[:2] == want
    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    cwant = ClusterScanEngine(clusters.profiles, k=6, device="cpu").record_streams(codes, thrs)
    assert any(len(st) for _, st in cwant)
    for mesh in (two, one):
        assert ShardedClusterScanEngine(clusters.profiles, k=6, mesh=mesh, chunk_windows=2048).record_streams(codes, thrs) == cwant


# --- across processes, and on the card ------------------------------------------------


def test_two_process_two_axis_step():
    """Two gloo processes, each with two logical CPU shards on the clusters
    axis, the data axis across them: every rank gets one process's
    outputs."""
    run_workers("cpu", mode="two_axis")


@pytest.mark.cuda
def test_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    rng = np.random.default_rng(2)
    k, ws, r, t, cap = 6, 289, 21, 2048, 64
    codes = rng.integers(0, 4, 40 * t, dtype=np.int8)
    s = rng.integers(0, 40, (4, 4**k)).astype(np.int32)
    thr = np.array([np.percentile(scan_window_distances_np_i64(codes, p, k, ws, r), 3) for p in s], dtype=np.int32)
    first = torch.device("cuda", 0)
    for nc, nd in [(1, 1), (1, 4), (2, 2), (4, 1)]:
        tiles, _ = make_tiles(codes, t, ws, nd)
        kw = dict(k=k, ws=ws, r=r, cap=cap)
        want = sharded_cluster_scan_step(tiles, s, thr, mesh=make_mesh(nc * nd, n_clusters=nc, device="cpu"), **kw)
        scan_kernels.match_counts.launches = 0
        got = sharded_cluster_scan_step(tiles, s, thr, mesh=make_mesh(devices=[first] * (nc * nd), n_clusters=nc), **kw)
        assert scan_kernels.match_counts.launches == nc * nd
        assert all(a.device == first and a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(got, want))
