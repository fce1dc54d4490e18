"""The port's plain scan contracts (kmergma_tpu_torch.ops.scan and the CPU
routes of its kernel wrappers) against the JAX package's
(kmergma_tpu.ops.scan): the same seeded numpy inputs go through both, with
zero tolerance - every value is integer arithmetic.  Pallas paths are
reached through their plain XLA references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops.kmers import kmer_count
from kmergma_tpu.ops.reference import gen_ref_ws_cons
from kmergma_tpu.utils.fasta import as_records
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.scan_kernels import scan_window_distances_kernel

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def cases(ref_fasta):
    """name -> (codes int8, S int64, k, ws, r): a small random profile at
    k=3/ws=20 and the real Alp_V profile at k=6/ws=289, each on a seeded
    random record with mutated reference copies planted."""
    rng = np.random.default_rng(11)
    out = {}
    k, ws, r = 3, 20, 7
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    s = sum(kmer_count(x, k).astype(np.int64) for x in refs)
    codes = rng.integers(0, 4, 3_000, dtype=np.int8)
    for pos in range(100, 2_900, 400):
        codes[pos : pos + ws] = refs[pos % r]
    out["k3"] = (codes, s, k, ws, r)

    p = gen_ref_ws_cons(ref_fasta, 6)
    genes = [rec.codes for rec in as_records(ref_fasta)]
    codes = rng.integers(0, 4, 12_000, dtype=np.int8)
    for j, pos in enumerate(range(500, 11_000, 2_500)):
        gene = genes[j].copy()
        idx = rng.integers(0, gene.shape[0], 20)
        gene[idx] = rng.integers(0, 4, 20)
        codes[pos : pos + gene.shape[0]] = gene
    out["k6"] = (codes, p.sum_kfv, 6, p.windowsize, p.n_records)
    return out


CASES = ["k3", "k6"]


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x) if dtype is None else np.asarray(x, dtype=dtype))


@pytest.mark.parametrize("name", CASES)
def test_rolling_codes_and_lookup(cases, name):
    codes, s, k, ws, r = cases[name]
    want_k = np.asarray(jscan.rolling_kmer_codes_jnp(jnp.asarray(codes), k))
    got_k = tscan.rolling_kmer_codes(_t(codes), k)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    want_g = np.asarray(jscan.profile_lookup(jnp.asarray(want_k), jnp.asarray(s.astype(np.int32))))
    got_g = tscan.profile_lookup(got_k, _t(s, np.int32))
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    # the batched form (region rows) equals the 1D form row by row
    rows = _t(codes[: 4 * 500].reshape(4, 500))
    for i in range(4):
        np.testing.assert_array_equal(
            tscan.rolling_kmer_codes(rows, k)[i].numpy(),
            tscan.rolling_kmer_codes(rows[i], k).numpy(),
        )


@pytest.mark.parametrize("name", CASES)
def test_window_distances(cases, name):
    codes, s, k, ws, r = cases[name]
    want = np.asarray(jscan.scan_window_distances(jnp.asarray(codes), jnp.asarray(s.astype(np.int32)), k, ws, r))
    s_t = _t(s, np.int32)
    got = tscan.scan_window_distances(_t(codes), s_t, k, ws, r)
    np.testing.assert_array_equal(got.numpy(), want)
    # the K2 route (plain twin on the CPU), tiled so tiles and the ragged
    # last tile are exercised
    got_k2 = scan_window_distances_kernel(_t(codes), s_t, k, ws, r, tile_windows=512)
    np.testing.assert_array_equal(got_k2.numpy(), want)
    np.testing.assert_array_equal(want, jscan.scan_window_distances_np(codes, s, k, ws, r))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("depth", [1, 16])
def test_lower_bounds(cases, name, depth):
    codes, s, k, ws, r = cases[name]
    depth = min(depth, ws - k)
    s32 = s.astype(np.int32)
    want = np.asarray(jscan.scan_window_lower_bounds(jnp.asarray(codes), jnp.asarray(s32), k, ws, r, depth))
    got = tscan.scan_window_lower_bounds(_t(codes), _t(s32), k, ws, r, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    l0 = np.asarray(jscan._first_window_l0(jnp.asarray(codes), jnp.asarray(s32), k=k, ws=ws, r=r, depth=depth))
    got_l0 = tscan._first_window_l0(_t(codes), _t(s32), k=k, ws=ws, r=r, depth=depth)
    assert int(got_l0) == int(l0) == int(want[0])
    # at full depth the bound is the exact distance
    exact = tscan.scan_window_lower_bounds(_t(codes), _t(s32), k, ws, r, ws - k)
    np.testing.assert_array_equal(exact.numpy(), tscan.scan_window_distances(_t(codes), _t(s32), k, ws, r).numpy())


@pytest.mark.parametrize("name", CASES)
def test_scan_rows_d(cases, name):
    codes, s, k, ws, r = cases[name]
    rspan = 256
    rng = np.random.default_rng(3)
    starts = np.sort(rng.integers(0, codes.shape[0] - rspan - ws, 6))
    rows = np.stack([codes[a : a + rspan + ws - 1] for a in starts])
    s32 = s.astype(np.int32)
    ref = jax.jit(jscan._scan_rows_d, static_argnums=(2, 3, 4, 5))
    want = np.asarray(ref(jnp.asarray(rows), jnp.asarray(s32), k, ws, r, False))
    got = tscan._scan_rows_d(_t(rows), _t(s32), k, ws, r)
    np.testing.assert_array_equal(got.numpy(), want)
    full = tscan.scan_window_distances(_t(codes), _t(s32), k, ws, r).numpy()
    for i, a in enumerate(starts):
        np.testing.assert_array_equal(got[i].numpy(), full[a : a + rspan])


def test_thresholds_and_headroom(ref_fasta):
    p = gen_ref_ws_cons(ref_fasta, 6)
    port = tscan.ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, device="cpu")
    ref = jscan.ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records)
    for thr in (0.0, 10.0, 29.857281746031738, 30.0, 36.5, 1e9):
        assert port._thr_int(thr) == ref._thr_int(thr)
        assert port._thr_exact(thr) == ref._thr_exact(thr)
    big = p.sum_kfv * 1000
    with pytest.raises(OverflowError):
        jscan.check_int32_headroom(big, p.windowsize, 6, p.n_records * 1000)
    with pytest.raises(OverflowError):
        tscan.check_int32_headroom(big, p.windowsize, 6, p.n_records * 1000)
    s, k, ws, r = profile = tscan.profile_to_torch(p, "cpu")
    assert s.dtype == torch.int32 and (k, ws, r) == (6, p.windowsize, p.n_records)
    np.testing.assert_array_equal(s.numpy(), p.sum_kfv)
    assert len(profile) == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_run_reduce(seed):
    """Run extraction and per-run (min, first-argmin) against the JAX
    segmented-scan reduce, on random distances with ties, runs that cross
    adjacent regions and gaps between regions."""
    rng = np.random.default_rng(seed)
    n_regions, rspan, R = 7, 64, 256
    d = rng.integers(0, 40, (n_regions, rspan)).astype(np.int32)  # many ties
    below = rng.random((n_regions, rspan)) < 0.4
    gaps = rng.integers(1, 3, n_regions) * rspan
    gaps[rng.random(n_regions) < 0.5] = rspan  # half the regions adjacent
    starts = np.concatenate([[0], np.cumsum(gaps[1:])]).astype(np.int32)
    mi = int(starts[-1]) + rspan - 10  # cut the tail of the last region
    ref = jax.jit(jscan._device_run_reduce, static_argnums=(3,), static_argnames=("run_bucket",))
    want = np.asarray(ref(jnp.asarray(d), jnp.asarray(below), jnp.asarray(starts), rspan, jnp.int32(mi), run_bucket=R))
    got = tscan._device_run_reduce(_t(d), _t(below), _t(starts).to(torch.int64), rspan, mi, R)
    assert 0 < int(got[0]) <= R
    np.testing.assert_array_equal(got.numpy(), want)
