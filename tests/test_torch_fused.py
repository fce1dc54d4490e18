"""K1's wrapper (kmergma_tpu_torch.ops.scan_fused.fused_record_bitmaps,
its plain twin on the CPU) against the JAX package's blocked lower bounds
(kmergma_tpu.ops.scan.scan_window_lower_bounds): one 0/1 per 512-window
block, any(L < thr), masked to p < nw.  Zero tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops.reference import gen_ref_ws_cons
from kmergma_tpu.utils.fasta import as_records
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def profile6(ref_fasta):
    return gen_ref_ws_cons(ref_fasta, 6)


def _record(ref_fasta, n, seed):
    rng = np.random.default_rng(seed)
    genes = [rec.codes for rec in as_records(ref_fasta)]
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for j, pos in enumerate(range(1_000, n - 400, 7_000)):
        codes[pos : pos + genes[j].shape[0]] = genes[j]
    return codes


def _blocked(bounds, thr, n_blocks, block):
    below = np.zeros(n_blocks * block, dtype=bool)
    below[: bounds.shape[0]] = bounds < thr
    return below.reshape(n_blocks, block).any(axis=1)


@pytest.mark.parametrize(
    "n,t,thr_pct",
    [
        (20_000, 4096, 0.5),  # nw < 65536: one planned pass all the same
        (70_000, 4096, 2.0),  # many tiles, ragged last tile
        (70_000, 1024, 2.0),  # tiles of two blocks: many tile bases
        (2_000, 512, 50.0),  # a record shorter than one tile
    ],
)
def test_bitmap_matches_blocked_jax_bounds(ref_fasta, profile6, n, t, thr_pct):
    p = profile6
    k, ws, r = 6, p.windowsize, p.n_records
    depth = min(16, ws - k)
    block = 512
    codes = _record(ref_fasta, n, seed=n + t)
    s32 = p.sum_kfv.astype(np.int32)
    nw = n - ws + 1
    n_tiles = -(-nw // t)
    L = np.asarray(jscan.scan_window_lower_bounds(jnp.asarray(codes), jnp.asarray(s32), k, ws, r, depth))
    thr = int(np.percentile(L, thr_pct))
    want = _blocked(L, thr, n_tiles * (t // block), block)

    padded = np.zeros(n_tiles * t + tscan._k1_halo(ws - k + 1), dtype=np.int8)
    padded[:n] = codes
    dev = torch.from_numpy(padded)
    s_t = torch.from_numpy(s32)
    l0 = tscan._first_window_l0(dev, s_t, k=k, ws=ws, r=r, depth=depth)
    got = fused_record_bitmaps(dev, s_t, thr=thr, l0=l0, nw=nw, k=k, ws=ws, r=r, depth=depth, t=t, block=block, n_tiles=n_tiles)
    assert got.dtype == torch.int32 and got.shape == (n_tiles, t // block)
    np.testing.assert_array_equal(got.reshape(-1).numpy().astype(bool), want)
    assert 0 < int(got.sum()) < got.numel()


def test_bitmap_rejects_bad_shapes(profile6):
    p = profile6
    k, ws, r = 6, p.windowsize, p.n_records
    s_t = torch.from_numpy(p.sum_kfv.astype(np.int32))
    codes = torch.zeros(4096 + tscan._k1_halo(ws - k + 1), dtype=torch.int8)
    l0 = tscan._first_window_l0(codes, s_t, k=k, ws=ws, r=r, depth=16)
    kw = dict(k=k, ws=ws, r=r, depth=16, block=512, n_tiles=1)
    with pytest.raises(ValueError):  # tile not a multiple of the block
        fused_record_bitmaps(codes, s_t, thr=0, l0=l0, nw=100, t=1000, **kw)
    with pytest.raises(ValueError):  # codes too short for the tile and halo
        fused_record_bitmaps(codes[:4096], s_t, thr=0, l0=l0, nw=100, t=4096, **kw)
    with pytest.raises(ValueError):  # int32 codes
        fused_record_bitmaps(codes.int(), s_t, thr=0, l0=l0, nw=100, t=4096, **kw)
    with pytest.raises(ValueError, match="depth <= 255"):  # K3's kernel keeps pair counts as bytes
        fused_record_bitmaps(codes, s_t, thr=0, l0=l0, nw=100, t=4096, **{**kw, "depth": 256})
