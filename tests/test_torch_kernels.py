"""The hand-written CUDA kernels against their plain PyTorch twins.

The kernel tests need a CUDA device and skip without one (marker
``cuda``); on the CPU the wrappers run their plain twins, launch nothing,
and refuse other devices.  Zero tolerance: integer arithmetic.

The file needs no jax and no conftest fixture, so on a GPU host without
jax it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from kmergma_tpu.ops.kmers import kmer_count
from kmergma_tpu.ops.reference import gen_ref_ws_cons
from kmergma_tpu.utils.fasta import as_records
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps, fused_record_bitmaps_plain
from kmergma_tpu_torch.ops.scan_kernels import (
    _match_counts_plain,
    match_counts,
    scan_window_distances_kernel,
)

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


def test_cpu_wrappers_launch_nothing(record):
    codes, p = record
    fused_record_bitmaps.launches = 0
    match_counts.launches = 0
    eng, prep, nw, l0, kw = _bitmap_inputs(codes, p.sum_kfv, 6, p.windowsize, p.n_records, "cpu")
    thr = int(eng._thr_int(30.0))
    bm = fused_record_bitmaps(prep, eng.s_dev, thr, l0, nw, **kw)
    assert int(bm.sum()) > 0
    assert eng.record_stream(codes, 30.0)[1]
    assert fused_record_bitmaps.launches == 0
    assert match_counts.launches == 0


def test_wrappers_refuse_other_devices():
    tiles = torch.zeros((2, 10), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        match_counts(tiles, 4, 6)
    codes = torch.zeros(5000, dtype=torch.int8, device="meta")
    s = torch.zeros(16, dtype=torch.int32, device="meta")
    l0 = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_record_bitmaps(codes, s, 0, l0, 100, k=2, ws=20, r=1, depth=4, t=512, block=512, n_tiles=1)


@pytest.mark.cuda
def test_k1_matches_twin_on_card(record, cuda_device):
    codes, p = record
    eng, prep, nw, l0, kw = _bitmap_inputs(codes, p.sum_kfv, 6, p.windowsize, p.n_records, cuda_device)
    for thr in (int(eng._thr_int(30.0)), int(eng._thr_int(45.0))):
        before = fused_record_bitmaps.launches
        got = fused_record_bitmaps(prep, eng.s_dev, thr, l0, nw, **kw)
        torch.cuda.synchronize()
        assert fused_record_bitmaps.launches == before + 2
        want = fused_record_bitmaps_plain(prep, eng.s_dev, thr, l0, nw, **kw)
        assert torch.equal(got, want)
        assert int(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 8])
def test_k1_table_placements_on_card(k, cuda_device):
    """k=7: the 64 KB table in opt-in shared memory; k=8: a 256 KB table,
    read through the read-only cache."""
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
    got = fused_record_bitmaps(prep, eng.s_dev, thr, l0, nw, **kw)
    want = fused_record_bitmaps_plain(prep, eng.s_dev, thr, l0, nw, **kw)
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
