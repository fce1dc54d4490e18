"""The register-blocked net pair delta behind K2, K4 and K6 and the
once-counted pair counts of K5 (``csrc/pair_counts.cuh``,
``csrc/pair_multi.cu``), checked on the CPU against the port's twins and
the JAX package (zero tolerance: integer arithmetic).

A NumPy model of the routine with the kernels' own index arithmetic: tiles
of up to 2048 positions, 16 a thread, the staged tile with its 16-code
halo and one pad word per 16, each thread's 16 targets, the small route
(depth <= 16, both runs of 32 codes in registers, distances unrolled
behind a depth test) and the streaming route (depth >= 15, two thread
groups: the 15 head columns under the mask i <= j and the first half of
the unmasked middle, then the rest of the middle and the 15 tail columns
under i > q), the packed compares of tiles whose codes fit 16 bits (two
targets a 32-bit word, halfword minima, counts biased by the depth so no
half borrows) and the int32 compares of the others, K4's K codes rolled
from its codes, the results back through the padded buffer and cut at the
ragged end of the row, and K2's epilogue [K[p] == K[p+w]] - 1.  It is held
against the port's ``_match_counts_plain`` and ``_pair_ab``, the JAX
package's ``_pair_ab_xla`` (K2 through the identity
``match_counts(K, w, t)[p] == _pair_ab(K, w, t, w - 1)[p] + [K[p] == K[p+w]] - 1``)
and, for whole region rows' distances, ``_scan_rows_d(use_pallas=False)``.
K5's model is described where it starts, below.

The kernels themselves are held against the twins on the card by the
``cuda`` tests of ``tests/test_torch_kernels.py`` and by ``chip_smoke.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.kmers import kmer_count
from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
from kmergma_tpu_torch.ops.scan_kernels import (
    _PAIR_DEPTH_T,
    _codes_pair_multi_plain,
    _match_counts_plain,
    _pair_multi_need,
    pair_multi_launch_shape,
)
from kmergma_tpu_torch.utils.fasta import as_records

from ._k5_cases import K5_CASES, k5_case
from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REF = str(Path(__file__).parent / "data" / "Alp_V_ref.fasta")
R = 16  # positions a thread owns (kPairR)
HALO = 16  # staged codes before a tile (kPairHalo)
MAX_TILE = 2048  # positions a tile (kPairMaxTile)


def pad(x):
    """Where staged code x sits: one pad word per 16 (pair_pad)."""
    return x + (x >> 4)


def pair_tile_len(t: int) -> int:
    """K2's positions a tile for rows of t positions (pair_tile_len)."""
    return min(max(-(-t // (32 * R)), 1) * 32 * R, MAX_TILE)


def stage(get, T: int, w: int) -> np.ndarray:
    """(staged tile, whether every staged code fits 16 bits): code x in
    [-HALO, T + max(w, R)) at pad(x + HALO)."""
    span = HALO + T + max(w, R)
    s = np.full(pad(span - 1) + 1, -7, dtype=np.int64)  # pad words hold junk, never read
    s[pad(np.arange(span))] = get(np.arange(span) - HALO)
    return s, bool((s[pad(np.arange(span))] >> 16 == 0).all())


def thread_deltas(s: np.ndarray, T: int, w: int, depth: int, match: bool, part: str = "all") -> np.ndarray:
    """acc[thread, i]: the ``part``'s share of the ab of tile position 16 *
    thread + i on int32 compares (pair_deltas): "all" on the small route,
    "first" (head and the first half of the middle) or "second" (the rest)
    on the streaming route."""
    i0 = R * np.arange(T // R)[:, None]
    i = np.arange(R)[None, :]

    def at(x):
        return s[pad(x + HALO)]

    acc = np.zeros((T // R, R), dtype=np.int64)
    if part == "all":  # the small route: 32 codes a side in registers
        assert depth <= R
        m = np.arange(2 * R)[None, :]
        lr = at(i0 + w - R + m)  # K[p0 + w - 16 + m]
        rr = at(i0 + m)  # K[p0 + m]
        el, ll = lr[:, R:], rr[:, :R]
        for j in range(1, R + 1):
            if j <= depth:
                acc += lr[:, R - j : 2 * R - j] == el
                acc -= rr[:, j : j + R] == ll
    else:  # the streaming route: each column of the two runs once
        assert depth >= R - 1
        el, ll = at(i0 + w + i), at(i0 + i)
        lb, rb = i0 + w - depth, i0 + 1
        mid = (R - 1 + depth) // 2
        if part == "first":
            for j in range(R - 1):  # head: targets i <= j
                acc += (i <= j) * ((at(lb + j) == el).astype(np.int64) - (at(rb + j) == ll))
        for j in range(mid, depth) if part == "second" else range(R - 1, mid):  # middle: every target
            acc += (at(lb + j) == el).astype(np.int64) - (at(rb + j) == ll)
        if part == "second":
            for q in range(R - 1):  # tail: targets i > q
                j = depth + q
                acc += (i > q) * ((at(lb + j) == el).astype(np.int64) - (at(rb + j) == ll))
    if match and part != "second":
        acc += (ll == el).astype(np.int64) - 1
    return acc


M32 = 0xFFFFFFFF


def pack2(a, b):
    """__byte_perm(a, b, 0x5410): a's low half low, b's low half high."""
    return (a & 0xFFFF) | ((b & 0xFFFF) << 16)


def unequal2(x, mask: int):
    """__vimin3_u16x2(x, mask, mask): each half's minimum with the mask's."""
    lo = np.minimum(x & 0xFFFF, mask & 0xFFFF)
    hi = np.minimum((x >> 16) & 0xFFFF, mask >> 16)
    return lo | (hi << 16)


def thread_deltas16(s: np.ndarray, T: int, w: int, depth: int, match: bool, part: str = "all") -> np.ndarray:
    """thread_deltas on the packed compares (pair_deltas16): target pairs
    two to a 32-bit word, unequal halves by a halfword minimum, the net
    count biased by depth in each half, all arithmetic modulo 2^32 as the
    kernel's."""
    i0 = R * np.arange(T // R)[:, None]
    mm = np.arange(R // 2)[None, :]

    def at(x):
        return s[pad(x + HALO)].astype(np.int64) & M32

    bias = (depth * 0x00010001) & M32
    acc2 = np.full((T // R, R // 2), bias, dtype=np.int64)

    def add(nr, nl):
        nonlocal acc2
        acc2 = (acc2 + nr - nl) & M32

    if part == "all":
        m = np.arange(2 * R)[None, :]
        lr, rr = at(i0 + w - R + m), at(i0 + m)
        pl, pr = pack2(lr[:, :-1], lr[:, 1:]), pack2(rr[:, :-1], rr[:, 1:])  # (x[q], x[q + 1])
        el2, ll2 = pl[:, R + 2 * mm[0]], pr[:, 2 * mm[0]]
        for j in range(1, R + 1):
            if j <= depth:
                add(unequal2(pr[:, 2 * mm[0] + j] ^ ll2, 0x10001), unequal2(pl[:, R + 2 * mm[0] - j] ^ el2, 0x10001))
    else:
        el2 = pack2(at(i0 + w + 2 * mm), at(i0 + w + 2 * mm + 1))
        ll2 = pack2(at(i0 + 2 * mm), at(i0 + 2 * mm + 1))
        lb, rb = i0 + w - depth, i0 + 1
        mid = (R - 1 + depth) // 2

        def cols(j):
            cl, cr = at(lb + j) & 0xFFFF, at(rb + j) & 0xFFFF  # both halves of a word
            return cl | (cl << 16), cr | (cr << 16)

        if part == "first":
            for j in range(R - 1):  # head: both halves when 2m + 1 <= j, the low when 2m == j
                cl, cr = cols(j)
                mask = np.where(2 * mm + 1 <= j, 0x10001, np.where(2 * mm == j, 0x1, 0))
                add(unequal2(cr ^ ll2, mask), unequal2(cl ^ el2, mask))
        for j in range(mid, depth) if part == "second" else range(R - 1, mid):
            cl, cr = cols(j)
            add(unequal2(cr ^ ll2, 0x10001), unequal2(cl ^ el2, 0x10001))
        if part == "second":
            for q in range(R - 1):  # tail: both halves when 2m > q, the high when 2m == q
                cl, cr = cols(depth + q)
                mask = np.where(2 * mm > q, 0x10001, np.where(2 * mm == q, 0x10000, 0))
                add(unequal2(cr ^ ll2, mask), unequal2(cl ^ el2, mask))
    assert ((acc2 & 0xFFFF) <= 2 * depth).all() and ((acc2 >> 16) <= 2 * depth).all()  # no half borrowed
    acc = np.empty((T // R, R), dtype=np.int64)
    acc[:, 0::2] = (acc2 & 0xFFFF) - depth
    acc[:, 1::2] = (acc2 >> 16) - depth
    if match and part != "second":
        ne = unequal2(ll2 ^ el2, 0x10001)
        acc[:, 0::2] -= ne & 0xFFFF
        acc[:, 1::2] -= ne >> 16
    return acc


def tile_deltas(s: np.ndarray, T: int, w: int, depth: int, match: bool, narrow: bool) -> np.ndarray:
    """pair_tile_deltas before the store: the packed compares when every
    staged code fits 16 bits, the small route in one part, the streaming
    route as the sum of its two thread groups' parts."""
    f = thread_deltas16 if narrow and depth < 2**15 else thread_deltas
    if depth <= R:
        return f(s, T, w, depth, match, "all")
    return f(s, T, w, depth, match, "first") + f(s, T, w, depth, match, "second")


def tile_out(s: np.ndarray, acc: np.ndarray, n_out: int) -> np.ndarray:
    """The results through the padded buffer, the first n_out of them."""
    buf = s.copy()
    T = acc.size
    buf[pad(np.arange(T))] = acc.reshape(-1)
    return buf[pad(np.arange(max(n_out, 0)))]


def model_match_counts(flat: np.ndarray, row_stride: int, n_rows: int, t: int, w: int) -> np.ndarray:
    """K2 (kmg_match_counts): row r is flat[r * row_stride : + t + w]."""
    T = pair_tile_len(t)
    out = np.full((n_rows, t), -(10**9), dtype=np.int64)
    for r in range(n_rows):
        row = flat[r * row_stride : r * row_stride + t + w]
        for tile in range(0, t, T):

            def get(x, tile=tile, row=row):
                i = tile + x
                ok = (i >= 0) & (i < t + w)
                return np.where(ok, row[np.clip(i, 0, t + w - 1)], 0)

            s, narrow = stage(get, T, w)
            acc = tile_deltas(s, T, w, w - 1, True, narrow)
            n_out = min(T, t - tile)
            out[r, tile : tile + n_out] = tile_out(s, acc, n_out)
    return out


def model_pair_kcodes(kc: np.ndarray, w: int, nt: int, depth: int, t: int = _PAIR_DEPTH_T) -> np.ndarray:
    """K6 (kmg_pair_depth_kcodes): tiles of t positions over the K codes,
    zero past their end."""
    n = kc.shape[0]
    out = np.full(nt, -(10**9), dtype=np.int64)
    for tile in range(0, max(nt, 1), t):

        def get(x, tile=tile):
            i = tile + x
            ok = (i >= 0) & (i < n)
            return np.where(ok, kc[np.clip(i, 0, n - 1)], 0)

        s, narrow = stage(get, t, w)
        acc = tile_deltas(s, t, w, depth, False, narrow)
        n_out = min(t, nt - tile)
        out[tile : tile + n_out] = tile_out(s, acc, n_out)
    return out


def model_pair_codes(codes: np.ndarray, k: int, w: int, nt: int, nkc: int, depth: int, t: int = _PAIR_DEPTH_T):
    """K4 on its register-blocked route (kmg_pair_depth_codes): at k = 1 the
    codes are staged as they are; at k > 1 each of the tile's threads builds
    a run of consecutive staged K codes, the first by its sum and the rest
    rolling, K[x] = 4 K[x - 1] - 4^k c[x - 1] + c[x + k - 1] modulo 2^32,
    zero off [0, t + w)."""
    n_tiles = max(1, -(-max(nt, nkc) // t))
    buf = np.zeros(n_tiles * t + w + k - 1, dtype=np.int64)
    buf[: codes.shape[0]] = codes[: buf.shape[0]]
    ab = np.full(nt, -(10**9), dtype=np.int64)
    kc = np.full(nkc, -1, dtype=np.int64)
    span = HALO + t + max(w, R)
    threads = t // R * (1 if depth <= R else 2)
    run = -(-span // threads)
    for b in range(n_tiles):
        raw = buf[b * t : b * t + t + w + k - 1] & M32
        staged = np.zeros(span, dtype=np.int64)
        for lo in range(0, span, run) if k > 1 else ():
            v, rolling = 0, False
            for i in range(lo, min(lo + run, span)):
                x = i - HALO
                if 0 <= x < t + w:
                    if rolling:
                        v = (4 * v - (4**k % 2**32) * raw[x - 1] + raw[x + k - 1]) % 2**32
                    else:
                        for j in range(k):
                            v = (4 * v + raw[x + j]) % 2**32
                        rolling = True
                    staged[i] = v
        if k == 1:
            staged[HALO : HALO + t + w] = raw[: t + w]

        def get(x, staged=staged):
            return staged[x + HALO]

        s, narrow = stage(get, t, w)
        tile = b * t
        n_kc = min(t, nkc - tile)
        if n_kc > 0:
            kc[tile : tile + n_kc] = s[pad(np.arange(n_kc) + HALO)]
        n_out = min(t, nt - tile)
        if n_out > 0:
            ab[tile : tile + n_out] = tile_out(s, tile_deltas(s, t, w, depth, False, narrow), n_out)
    return ab, kc


def _kcodes(n: int, k: int, seed: int, run: tuple | None = None) -> np.ndarray:
    """int32 K codes of a seeded record, a quarter of it low-complexity
    (so codes repeat inside a window), optionally with a run of one code."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n + k - 1, dtype=np.int8)
    q = n // 4
    codes[q : 2 * q] = np.tile(rng.integers(0, 4, 7, dtype=np.int8), -(-q // 7))[:q]
    kc = tscan.rolling_kmer_codes(torch.from_numpy(codes), k).numpy().astype(np.int64)
    if run is not None:
        a, b = run
        kc[a:b] = kc[a]
    return kc


# (k, w, depth, nt, run): depths 1, 14, 16, 17 and w - 1; nt off a
# multiple of 16 and of the 2048-position tile; a run longer than w; k = 10
K6_CASES = {
    "d1": (6, 284, 1, 5_000 - 284 - 3, None),
    "d14_w15": (6, 15, 14, 4_100 - 15 - 5, None),
    "d16": (6, 284, 16, 2 * 2048 + 17, None),
    "d17": (6, 284, 17, 3_001, (100, 600)),
    "d_w_minus_1": (6, 284, 283, 2_048 + 1, (700, 1_200)),
    "w2_d1": (6, 2, 1, 333, None),
    "k10_d16": (10, 284, 16, 4_111, None),
    "k10_d_w_minus_1": (10, 120, 119, 2_500, (50, 400)),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_pair_ab_routes_match_twin_and_jax(case):
    """K6's routine (and so K4's and K4r's depth-loop shapes) against the
    port's ``_pair_ab`` and the JAX package's ``_pair_ab_xla``."""
    k, w, depth, nt, run = K6_CASES[case]
    kc = _kcodes(nt + w + 29, k, seed=len(case), run=run)
    got = model_pair_kcodes(kc, w, nt, depth)
    want = np.asarray(jscan._pair_ab_xla(jnp.asarray(kc.astype(np.int32)), w, nt, depth))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tscan._pair_ab(torch.from_numpy(kc.astype(np.int32)), w, nt, depth).numpy(), want)
    if run is not None:  # a run of one code longer than w: a full count
        assert int(np.abs(got).max()) == depth
    if k == 10:
        assert kc.max() >= 2**16  # codes past 16 bits compare as int32


@pytest.mark.parametrize("k,w,depth", [(6, 15, 14), (6, 284, 16), (1, 283, 282), (10, 120, 17)])
def test_pair_codes_route_builds_kcodes_and_ab(k, w, depth):
    """K4's staging (K codes built from codes inside [0, t + w) of each
    tile) feeding the same routine, against the port's twin of K4."""
    from kmergma_tpu_torch.ops.scan_kernels import _codes_pair_ab_kcodes_plain

    rng = np.random.default_rng(w)
    hi = 256 if k == 1 else 4
    codes = rng.integers(0, hi, 5_000).astype(np.int32)
    codes[1_000:1_500] = 3
    nt, nkc = 5_000 - w - k - 11, 5_000 - k - 6
    ab, kc = model_pair_codes(codes, k, w, nt, nkc, depth)
    ab_p, kc_p = _codes_pair_ab_kcodes_plain(torch.from_numpy(codes), k, w, nt, nkc, depth)
    np.testing.assert_array_equal(ab, ab_p.numpy())
    np.testing.assert_array_equal(kc, kc_p.numpy())


# (k, w, t, n_rows, row_stride or None for region rows of t + w, run)
K2_CASES = {
    "regions_1024": (6, 284, 1024, 5, None, None),
    "whole_record_2048": (6, 284, 2048, 4, 2048, (3_000, 3_400)),  # overlapping rows
    "t_off_16": (6, 284, 1000, 3, 1000, None),
    "t_multi_tile": (6, 284, 2049 + 2048, 2, None, (10, 400)),  # three tiles a row
    "t_17": (6, 284, 17, 6, None, None),
    "w17_small_route": (6, 17, 333, 3, 100, (40, 90)),
    "w18_stream_route": (6, 18, 333, 3, None, None),
    "w1": (6, 1, 64, 2, None, None),
    "k10": (10, 120, 1024, 3, 1024, (500, 700)),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_match_counts_routine_matches_twin_and_jax(case):
    """K2 = the routine at depth w - 1 with the epilogue, on region rows
    and on overlapping rows of a whole record, against the port's
    ``_match_counts_plain`` and the JAX package's ``_pair_ab_xla`` through
    the K2 identity."""
    k, w, t, n_rows, stride, run = K2_CASES[case]
    stride = t + w if stride is None else stride
    flat = _kcodes((n_rows - 1) * stride + t + w, k, seed=t + w, run=run)
    got = model_match_counts(flat, stride, n_rows, t, w)
    rows = np.stack([flat[r * stride : r * stride + t + w] for r in range(n_rows)])
    np.testing.assert_array_equal(got, _match_counts_plain(torch.from_numpy(rows.astype(np.int32)), w, t).numpy())
    for r in range(n_rows):
        row = rows[r]
        pair = np.asarray(jscan._pair_ab_xla(jnp.asarray(row.astype(np.int32)), w, t, w - 1))
        np.testing.assert_array_equal(got[r], pair + (row[:t] == row[w : w + t]) - 1)
    if run is not None and run[1] - run[0] > w:  # a run longer than w leaving: AB = -w
        assert int(np.abs(got).max()) == w


@pytest.mark.parametrize("rspan", [1024, 1000])
def test_region_rows_distances_match_jax_scan_rows(rspan):
    """Whole region rows' distances from the routine's AB, against the JAX
    package's ``_scan_rows_d(use_pallas=False)`` and the port's
    ``_scan_rows_d`` (whose CPU route runs K2's twin)."""
    p = gen_ref_ws_cons(REF, 6)
    k, ws, r = 6, p.windowsize, p.n_records
    w = ws - k + 1
    genes = [rec.codes for rec in as_records(REF)]
    rng = np.random.default_rng(rspan)
    codes = rng.integers(0, 4, 12_000, dtype=np.int8)
    for j, pos in enumerate(range(500, 11_000, 2_500)):
        codes[pos : pos + genes[j].shape[0]] = genes[j]
    starts = [0, 480, 2_400, 7_313, 12_000 - rspan - ws + 1]
    rows = np.stack([codes[s : s + rspan + ws - 1] for s in starts])
    s_prof = p.sum_kfv.astype(np.int32)

    # the port's _scan_rows_d with the model's AB in place of K2
    kc = tscan.rolling_kmer_codes(torch.from_numpy(rows), k).numpy().astype(np.int64)
    tiles = np.pad(kc, ((0, 0), (0, rspan + w - kc.shape[1])))
    ab = model_match_counts(tiles.reshape(-1), rspan + w, len(starts), rspan, w)[:, : rspan - 1]
    g = s_prof[kc].astype(np.int64)
    nt = rspan - 1
    kl, kr = kc[:, :nt], kc[:, w : w + nt]
    r2 = 2 * r * r
    delta = r2 * (kl != kr) + r2 * ab + 2 * r * (g[:, :nt] - g[:, w : w + nt])
    want = np.asarray(jscan._scan_rows_d(jnp.asarray(rows), jnp.asarray(s_prof), k, ws, r, False))
    d0 = want[:, :1].astype(np.int64)
    got = np.concatenate([d0, d0 + np.cumsum(delta, axis=1)], axis=1)
    np.testing.assert_array_equal(got, want)
    port = tscan._scan_rows_d(torch.from_numpy(rows), torch.from_numpy(s_prof), k, ws, r).numpy()
    np.testing.assert_array_equal(port, want)
    # and d0 itself from the window's counts: the model's distances are exact
    counts = np.stack([kmer_count(row[: ws], k).astype(np.int64) for row in rows])
    np.testing.assert_array_equal(d0[:, 0], ((r * counts - p.sum_kfv.astype(np.int64)) ** 2).sum(axis=1))


# ---- K5: the once-counted pair counts of every windowsize group -------------
#
# A NumPy model of ``csrc/pair_multi.cu`` with the kernel's own index
# arithmetic: the tile and block from the record's length, the tile's codes
# packed 16 to a word from 16-byte granules (junk before the codes, zeros
# past them), one unit of 16 left ends a lane (u = u0 + tid, so lane = u %
# 32 and a warp is a chunk of 32 units; lanes past the last unit compute on
# the last unit's codes and vote with them), each unit's 33 K codes from
# three funnel-aligned words, each pair (a, a + j) compared once for Ru[a]
# and Lu[a + j] (packed halves on warps whose codes fit 16 bits, int32
# otherwise), the carry of the next unit's 16 positions by a shuffle up one
# lane and from lane 31 through the chunk's edge slot, the plain loop at
# depths above 16, and the rows ab[g, p] = Ru[p] - Lu[p + w_g] read four
# bytes at a time through a funnel shift into rows padded to whole fours.


def byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4 i) & 7
    of the eight bytes of y:x."""
    v = (np.asarray(y, dtype=np.uint64) << np.uint64(32)) | np.asarray(x, dtype=np.uint64)
    out = np.zeros(v.shape, dtype=np.int64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.int64) << (8 * i)
    return out


def funnel_l(lo, hi, sh):
    """__funnelshift_l(lo, hi, sh): the high word of (hi:lo) << (sh & 31)."""
    v = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)
    return ((v << (np.asarray(sh, dtype=np.uint64) & np.uint64(31))) >> np.uint64(32)).astype(np.int64) & M32


def funnel_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the low word of (hi:lo) >> (sh & 31)."""
    v = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)
    return (v >> (np.asarray(sh, dtype=np.uint64) & np.uint64(31))).astype(np.int64) & M32


def pack4(w):
    """Four byte codes (first lowest) as 8 bits, the first code highest."""
    return sum(((w >> (8 * b)) & 3) << (6 - 2 * b) for b in range(4))


def k5_codes2(codes: np.ndarray, mis: int, tile_pos: int, n_words: int) -> np.ndarray:
    """The tile's codes packed 16 to a word: granule q is the 16 bytes from
    tile_pos + 16 q - mis of the codes, junk before them, zeros past them."""
    idx = tile_pos + 16 * np.arange(n_words)[:, None] + np.arange(16)[None, :] - mis
    raw = np.where(idx < 0, 0xA5, codes[np.clip(idx, 0, max(codes.shape[0] - 1, 0))] if codes.size else 0)
    raw = np.where(idx >= codes.shape[0], 0, raw).astype(np.int64) & 0xFF
    words = raw[:, 0::4] | raw[:, 1::4] << 8 | raw[:, 2::4] << 16 | raw[:, 3::4] << 24  # uint4 .x .. .w
    return pack4(words[:, 0]) << 24 | pack4(words[:, 1]) << 16 | pack4(words[:, 2]) << 8 | pack4(words[:, 3])


def k5_kcode_at(codes2: np.ndarray, s, kk: int):
    """kcode_at: the K code of kk codes from stream code s."""
    s = np.asarray(s)
    return funnel_l(codes2[(s >> 4) + 1], codes2[s >> 4], 2 * (s & 15)) >> (32 - 2 * kk)


def k5_unit_kcodes(codes2: np.ndarray, s: np.ndarray, kk: int) -> np.ndarray:
    """unit_kcodes: kv[u, i] for i <= 32 from three funnel-aligned words."""
    w = [codes2[(s >> 4) + j] for j in range(4)]
    sh = 2 * (s & 15)
    y = [funnel_l(w[j + 1], w[j], sh) for j in range(3)]
    kv = np.empty((s.shape[0], 33), dtype=np.int64)
    for i in range(16):
        kv[:, i] = funnel_l(y[1], y[0], 2 * i) >> (32 - 2 * kk)
        kv[:, 16 + i] = funnel_l(y[2], y[1], 2 * i) >> (32 - 2 * kk)
    kv[:, 32] = y[2] >> (32 - 2 * kk)
    return kv


def k5_unit_counts(kv: np.ndarray, depth: int, narrow: np.ndarray):
    """pair_unit_counts for every unit: (own, carry, rc) words of byte
    counts [n_units, 4], narrow units on packed halves, the others int32."""
    n = kv.shape[0]
    own, carry, rc = (np.zeros((n, 4), dtype=np.int64) for _ in range(3))
    # packed: pe[q] = (K[2q], K[2q + 1]), po[q] = (K[2q + 1], K[2q + 2])
    pe = pack2(kv[:, 0:32:2], kv[:, 1:32:2])
    po = pack2(kv[:, 1:33:2], kv[:, 2:33:2])
    r2 = np.zeros((n, 8), dtype=np.int64)
    le = np.zeros((n, 16), dtype=np.int64)
    lo = np.zeros((n, 16), dtype=np.int64)
    for j in range(1, 17):
        if j <= depth:
            for m in range(8):
                e = unequal2(pe[:, m] ^ (po[:, m + (j - 1) // 2] if j & 1 else pe[:, m + j // 2]), 0x10001)
                r2[:, m] += e
                if j & 1:
                    lo[:, m + (j - 1) // 2] += e
                else:
                    le[:, m + j // 2] += e
    for a in (r2, le, lo):  # each half counts at most depth unequal pairs: no half carries into the other
        assert ((a & 0xFFFF) <= depth).all() and ((a >> 16) <= depth).all()
    lo_prev = np.concatenate([np.zeros((n, 1), dtype=np.int64), lo[:, :-1]], axis=1)
    h = le + byte_perm(lo_prev, lo, 0x5432)
    p_own = [byte_perm(h[:, 2 * r], h[:, 2 * r + 1], 0x6420) for r in range(4)]
    p_carry = [byte_perm(h[:, 8 + 2 * r], h[:, 9 + 2 * r], 0x6420) for r in range(4)]
    p_rc = [byte_perm(r2[:, 2 * r], r2[:, 2 * r + 1], 0x6420) for r in range(4)]
    # int32: ru[i], lu[i + j]
    ru = np.zeros((n, 16), dtype=np.int64)
    lu = np.zeros((n, 32), dtype=np.int64)
    for j in range(1, 17):
        if j <= depth:
            e = (kv[:, :16] != kv[:, j : j + 16]).astype(np.int64)
            ru += e
            lu[:, j : j + 16] += e

    def bytes4(a):
        return a[:, 0] | a[:, 1] << 8 | a[:, 2] << 16 | a[:, 3] << 24

    for r in range(4):
        own[:, r] = np.where(narrow, p_own[r], bytes4(lu[:, 4 * r : 4 * r + 4]))
        carry[:, r] = np.where(narrow, p_carry[r], bytes4(lu[:, 16 + 4 * r : 20 + 4 * r]))
        rc[:, r] = np.where(narrow, p_rc[r], bytes4(ru[:, 4 * r : 4 * r + 4]))
    return own, carry, rc


def words_to_bytes(w: np.ndarray) -> np.ndarray:
    return ((w.reshape(-1, 1) >> (8 * np.arange(4))) & 0xFF).reshape(-1)


def model_pair_multi(codes: np.ndarray, k: int, ws_tuple: tuple, nt: int, nkc: int, depth: int, mis: int = 0):
    """K5 (kmg_pair_multi) on codes that start ``mis`` bytes past a 16-byte
    boundary: (ab[G, nt], kc[nkc]) and the launch shape."""
    shape = pair_multi_launch_shape(k, ws_tuple, nt, nkc)
    t, n_tiles, threads, n_units = shape["tile"], shape["grid"], shape["threads"], shape["units"]
    ws = [w_ - k + 1 for w_ in ws_tuple]
    w_min, w_max = min(ws), max(ws)
    assert n_units == -(-(t + w_max) // R) and threads % 32 == 0 and n_tiles * t >= max(nt, nkc)
    kk, ex = min(k, 16), max(k - 16, 0)
    base = mis + ex
    n_words = n_units + 5 + (ex + 15) // 16
    ab_stride, kc_stride = -(-nt // 4) * 4, -(-nkc // 4) * 4
    ab = np.full((len(ws), ab_stride), -(10**9), dtype=np.int64)
    kc = np.full(kc_stride, -(10**9), dtype=np.int64)
    u = np.arange(n_units)
    lane = (u - u // threads * threads) % 32  # u = u0 + tid, u0 a multiple of threads
    assert (lane == u % 32).all()
    for tile in range(n_tiles):
        tile_pos = tile * t
        codes2 = k5_codes2(codes, mis, tile_pos, n_words)
        lu = np.full(R * n_units + 8, 0x5A, dtype=np.int64)  # junk where nothing is written
        ru = np.full(t, 0x5A, dtype=np.int64)
        if depth <= R:
            n_lanes = -(-n_units // 32) * 32
            ur = np.minimum(np.arange(n_lanes), n_units - 1)  # lanes past the last unit take its codes
            kv = k5_unit_kcodes(codes2, R * ur + base, kk)
            fits = ((kv >> 16) == 0).all(axis=1).reshape(-1, 32).all(axis=1)  # __all_sync per warp
            narrow = np.repeat(fits | (kk <= 8), 32)
            own, carry, rc = k5_unit_counts(kv, depth, narrow)
            own, carry, rc = own[:n_units], carry[:n_units], rc[:n_units]
            own[1:] += np.where((lane[1:] > 0)[:, None], carry[:-1], 0)  # the shuffle up one lane
            edge = {int(x) >> 5: carry[x] for x in u[lane == 31]}  # lane 31's carry, per chunk
            for c in range(1, -(-n_units // 32)):  # after the barrier: each chunk's first unit
                own[32 * c] += edge[c - 1]
            lu[: R * n_units] = words_to_bytes(own)
            n_r = t // R
            ru[:] = words_to_bytes(rc[:n_r])
            assert (lu[: R * n_units] <= depth).all()
        else:  # the plain loop over K codes staged in shared memory
            kcs = k5_kcode_at(codes2, np.arange(R * n_units) + base, kk)
            x = np.arange(w_min, t + w_max)
            lu[x] = sum((kcs[x - d] != kcs[x]).astype(np.int64) for d in range(1, depth + 1))
            p = np.arange(t)
            ru[:] = sum((kcs[p + d] != kcs[p]).astype(np.int64) for d in range(1, depth + 1))
        luw = lu[: lu.shape[0] // 4 * 4].reshape(-1, 4) @ (1 << (8 * np.arange(4)))
        q = np.arange(t // 4)
        pos = tile_pos + 4 * q
        rows = pos < ab_stride
        for g, w_g in enumerate(ws):
            x = 4 * q[rows] + w_g
            l4 = funnel_r(luw[x >> 2], luw[(x >> 2) + 1], 8 * (x & 3))
            for i in range(4):
                ab[g, pos[rows] + i] = ru[4 * q[rows] + i] - ((l4 >> (8 * i)) & 0xFF)
        kcs_out = pos < kc_stride
        for i in range(4):
            kc[pos[kcs_out] + i] = k5_kcode_at(codes2, 4 * q[kcs_out] + i + base, kk)
    assert (ab[:, :nt] > -(10**9)).all() and (kc[:nkc] > -(10**9)).all()
    return ab[:, :nt], kc[:nkc], shape


def as_int32(x: np.ndarray) -> np.ndarray:
    return (x & M32).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", sorted(c for c, v in K5_CASES.items() if v[-1]))
def test_k5_route_matches_twin_and_jax(case):
    """The model of K5's route against the port's ``_codes_pair_multi_plain``
    and the JAX package's ``_pair_ab_xla`` on ``rolling_kmer_codes_jnp``
    (codes past the end read as zeros, as the JAX kernel's padding does)."""
    k, ws_tuple, depth, codes, nt, nkc, offset = k5_case(case)
    ab, kc, shape = model_pair_multi(codes, k, ws_tuple, nt, nkc, depth, mis=offset % 16)
    ab_p, kc_p = _codes_pair_multi_plain(torch.from_numpy(codes), k, ws_tuple, nt, nkc, depth)
    np.testing.assert_array_equal(as_int32(ab), ab_p.numpy())
    np.testing.assert_array_equal(as_int32(kc), kc_p.numpy())
    if k <= 15:  # K fits int32 without wrapping, as the JAX package keeps it
        padded = np.zeros(max(nt + max(ws_tuple) - k + 1, nkc) + k - 1, dtype=np.int8)
        padded[: min(codes.shape[0], padded.shape[0])] = codes[: padded.shape[0]]
        K = jscan.rolling_kmer_codes_jnp(jnp.asarray(padded), k)
        np.testing.assert_array_equal(kc, np.asarray(K)[:nkc])
        for g, ws in enumerate(ws_tuple):
            np.testing.assert_array_equal(ab[g], np.asarray(jscan._pair_ab_xla(K, ws - k + 1, nt, depth)))
    assert depth == 0 or int(np.abs(ab).max()) > 0
    if case == "wide_units_loop":
        assert shape["units"] > shape["threads"]  # units go round the block
    if case == "k10_d16":  # warps of both kinds: int32 compares and, on the run of A, packed
        assert shape["tile"] == 256


def test_k5_tile_fills_the_card_and_covers_the_record():
    """Short records (the split route's largest, 65,535 windows, and a 60 kb
    contig) take 256-position tiles, at least one block per SM of an H100;
    a 4 Mbp record 2048-position tiles, its w_max halo under a seventh of
    a tile; ``_pair_multi_need`` covers every code the tiles read, and the
    cluster engine pads a record to it."""
    ws = (288, 289, 290)
    for n, tile in ((16_000 - 288, 256), (60_000 - 288, 256), (65_535, 256), (4_000_000, 2048)):
        shape = pair_multi_launch_shape(6, ws, n, n + 284)
        assert shape["tile"] == tile
        n_tiles, need = _pair_multi_need(ws, n, n + 284)
        assert n_tiles == shape["grid"] and need == n_tiles * tile + max(ws)
        if n >= 59_000:
            assert shape["grid"] >= 132
    assert (shape["units"] * R - shape["tile"]) / shape["tile"] < 1 / 7
    eng = ClusterScanEngine(eliminate_null_params(cluster_ref_api(REF, 6)).profiles, k=6, device="cpu")
    for n in (16_000, 60_000):
        span = eng._split_span(n - min(g[0] for g in eng.groups) + 1)
        need = _pair_multi_need(tuple(g[0] for g in eng.groups), span - 1, span + eng.max_ws - 6)[1]
        assert eng.prepare_codes(np.zeros(n, dtype=np.int8)).shape[0] >= need
