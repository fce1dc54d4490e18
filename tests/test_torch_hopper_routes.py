"""What the Hopper routes of K4r and K1 rely on, checked on the CPU against
the JAX package (zero tolerance: integer arithmetic).

* K4r's sliding histogram (``csrc/pair_depth.cu``, byte codes at k = 1 and
  depth w - 1): a NumPy model of the kernel's segment recurrence, with its
  own index arithmetic (segment starts, the w - 1 start-up increments,
  16-position chunks, the record end, two 16-bit bins to a 32-bit word),
  against the plain twin ``_codes_pair_ab_kcodes_plain`` and the JAX
  package's ``_pair_ab_xla`` at depth w - 1.
* K1 as K3 at m = 1 (``fused_record_bitmaps`` launches K3's kernel with one
  profile): K3's plain twin at m = 1 equals K1's and the JAX package's
  blocked ``scan_window_lower_bounds``.

The kernels themselves are held against these twins on the card by the
``cuda`` tests of ``tests/test_torch_kernels.py`` and by ``chip_smoke.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu_torch.models.strobe_miner import gen_strobe_ref_ws_cons
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.kmers import kmer_count
from kmergma_tpu_torch.ops.scan_cluster_fused import fused_cluster_record_bitmaps, fused_cluster_record_bitmaps_plain
from kmergma_tpu_torch.ops.scan_fused import fused_record_bitmaps, fused_record_bitmaps_plain
from kmergma_tpu_torch.ops.scan_kernels import _codes_pair_ab_kcodes_plain, _pair_depth_need
from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes
from kmergma_tpu_torch.utils.fasta import as_records

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REF = str(Path(__file__).parent / "data" / "Alp_V_ref.fasta")
CHUNK = 16  # positions a kernel thread takes per step (kChunk)


def roll_hist_model(codes: np.ndarray, w: int, nt: int, nkc: int, seg: int):
    """K4r's sliding-histogram kernel, thread by thread: thread g walks
    positions [g * seg, (g + 1) * seg), starts its histogram with the w - 1
    codes K[p0 + 1 .. p0 + w - 1], and per position reads two bins and moves
    one code out and one in.  Bins are 16-bit halves of 32-bit words (bin v
    in word v >> 1, half v & 1), updated modulo 2^32 as the kernel does.
    ``codes`` is the buffer the kernel reads (zero-padded)."""
    assert seg % CHUNK == 0
    K = codes.astype(np.int64)
    n_out = max(nt, nkc)
    ab = np.full(nt, -(10**9), dtype=np.int64)
    kc = np.full(nkc, -1, dtype=np.int64)
    mask = 0xFFFFFFFF
    for p0 in range(0, n_out, seg):
        words = [0] * 128

        def get(v):
            return (words[v >> 1] >> (16 * (v & 1))) & 0xFFFF

        def add(v, one):
            words[v >> 1] = (words[v >> 1] + ((one << (16 * (v & 1))) & mask)) & mask

        if p0 < nt:
            for c in range(0, w, CHUNK):
                for b in range(CHUNK):
                    if 1 <= c + b < w:
                        add(int(K[p0 + c + b]), 1)
        p_end = min(p0 + seg, n_out)
        for p in range(p0, p_end, CHUNK):
            a = [0] * CHUNK
            if p < nt:
                for b in range(CHUNK):
                    vl, vr, vn = int(K[p + b]), int(K[p + b + w]), int(K[p + b + 1])
                    a[b] = get(vr) - get(vl)
                    add(vn, mask)  # minus one
                    add(vr, 1)
            for b in range(CHUNK):
                if p + b < nt:
                    ab[p + b] = a[b]
                if p + b < nkc:
                    kc[p + b] = K[p + b]
    return ab, kc


def _strobe_codes(n_bp: int) -> np.ndarray:
    """Real s = 2 strobe codes (uint8) of a record with planted genes."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, n_bp, dtype=np.int8)
    genes = [rec.codes for rec in as_records(REF)]
    for j, pos in enumerate(range(200, n_bp - 400, 1_300)):
        codes[pos : pos + genes[j].shape[0]] = genes[j]
    p = gen_strobe_ref_ws_cons(REF)
    return strobe_2_mer_codes(codes, p.s, p.w_min, p.w_max, p.q).astype(np.uint8), p.windowsize - p.k


def _k4r_case(name: str):
    """(codes, w, nt, nkc) of one parametrised case."""
    rng = np.random.default_rng(5)
    if name == "strobe":
        sc, w = _strobe_codes(4_000)
        return sc, w, sc.shape[0] - w - 37, sc.shape[0] - 1
    if name == "all256":
        codes = rng.permutation(np.tile(np.arange(256, dtype=np.uint8), 12))
        return codes, 40, codes.shape[0] - 40 - 3, codes.shape[0] - 5
    if name == "one_run":  # a run of one code: a count reaches w - 1 = 282
        codes = rng.integers(0, 256, 2_000).astype(np.uint8)
        codes[500:1_300] = 7
        return codes, 283, 2_000 - 283 - 1, 2_000 - 9
    if name == "short":  # fewer positions than one segment
        codes = rng.integers(0, 256, 300).astype(np.uint8)
        return codes, 283, 9, 292
    raise ValueError(name)


@pytest.mark.parametrize("seg", [16, 48, 288])
@pytest.mark.parametrize("case", ["strobe", "all256", "one_run", "short"])
def test_k4r_segment_recurrence_matches_twin_and_jax(case, seg):
    codes, w, nt, nkc = _k4r_case(case)
    need = _pair_depth_need(1, w, nt, nkc)[1]
    buf = np.zeros(need, dtype=np.uint8)
    buf[: codes.shape[0]] = codes
    ab, kc = roll_hist_model(buf, w, nt, nkc, seg)
    ab_t, kc_t = _codes_pair_ab_kcodes_plain(torch.from_numpy(buf), 1, w, nt, nkc, w - 1)
    want = np.asarray(jscan._pair_ab_xla(jnp.asarray(buf.astype(np.int32)), w, nt, w - 1))
    np.testing.assert_array_equal(ab, want)
    np.testing.assert_array_equal(ab_t.numpy(), want)
    np.testing.assert_array_equal(kc, buf[:nkc])
    np.testing.assert_array_equal(kc_t.numpy(), buf[:nkc])
    if case == "one_run":
        assert int(np.abs(ab).max()) == w - 1
    if case == "short":
        assert nt < seg


def _profile(k: int, ws: int, n_refs: int, seed: int):
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(n_refs)]
    return refs, sum(kmer_count(x, k).astype(np.int64) for x in refs).astype(np.int32)


@pytest.mark.parametrize(
    "k,ws,n,t",
    [
        (6, 289, 30_000, 4096),  # the main path's shape, the record ending inside the last tile
        (7, 120, 12_000, 1024),
        (10, 120, 9_000, 2048),  # a 4^10 table
        (6, 20, 6_000, 512),  # a short window: depth 14 < 16
    ],
)
def test_k1_is_k3_at_one_profile(k, ws, n, t):
    refs, s = _profile(k, ws, 5, seed=k + ws)
    r = len(refs)
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for j, pos in enumerate(range(300, n - ws, 2_500)):
        codes[pos : pos + ws] = refs[j % r]
    w = ws - k + 1
    depth = min(16, ws - k)
    nw = n - ws + 1
    n_tiles = -(-nw // t)
    block = 512
    assert nw % t  # the record ends inside a tile
    L = np.asarray(jscan.scan_window_lower_bounds(jnp.asarray(codes), jnp.asarray(s), k, ws, r, depth))
    thr = int(np.percentile(L, 3.0))
    below = np.zeros(n_tiles * t, dtype=bool)
    below[:nw] = L < thr
    want = below.reshape(-1, block).any(axis=1)

    padded = np.zeros(n_tiles * t + tscan._k1_halo(w), dtype=np.int8)
    padded[:n] = codes
    dev, s_t = torch.from_numpy(padded), torch.from_numpy(s)
    l0 = tscan._first_window_l0(dev, s_t, k=k, ws=ws, r=r, depth=depth)
    kw = dict(depth=depth, t=t, block=block, n_tiles=n_tiles)
    k1 = fused_record_bitmaps_plain(dev, s_t, thr=thr, l0=l0, nw=nw, k=k, ws=ws, r=r, **kw)
    k3 = fused_cluster_record_bitmaps_plain(dev, s_t[None], thrs=[thr], l0s=l0.view(1), nws=[nw], k=k, specs=[(ws, r)], **kw)
    assert k3.shape == (1, k1.numel())
    np.testing.assert_array_equal(k1.reshape(-1).numpy().astype(bool), want)
    np.testing.assert_array_equal(k3.reshape(-1).numpy(), k1.reshape(-1).numpy())
    # the wrappers' CPU routes are the twins
    got1 = fused_record_bitmaps(dev, s_t, thr=thr, l0=l0, nw=nw, k=k, ws=ws, r=r, **kw)
    got3 = fused_cluster_record_bitmaps(dev, s_t[None], thrs=[thr], l0s=l0.view(1), nws=[nw], k=k, specs=[(ws, r)], **kw)
    assert torch.equal(got1, k1) and torch.equal(got3.view_as(k1), k1)
    assert 0 < int(k1.sum()) < k1.numel()
