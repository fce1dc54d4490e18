"""Exact int64 host scan engine - the fallback for parameter regimes whose
scaled distances overflow the device int32 path.

``ops.scan.check_int32_headroom`` guards the TPU engine: huge reference
sets (R) or windows push D = ||R*c - S||^2 past 2^31.  This engine keeps
the scan EXACT in int64 via the native C++ O(1)/bp rolling recurrence (the
reference's own algorithm, ref KmerGMA.jl src/GenomeMiner.jl:42-77,
implemented in kmergma_tpu_torch/native/fastaio.cpp::scan_rolling_i64), with a
vectorised NumPy implementation when no C++ toolchain is available.  It
produces the identical (dist0, stream, dists) contract as ScanEngine, so
miners pick it up transparently (models/miner.py falls back on
OverflowError).
"""

from __future__ import annotations

import numpy as np


def check_int64_headroom(s_profile: np.ndarray, ws: int, k: int, r: int) -> None:
    """Same worst-case bound as check_int32_headroom, against 2^63."""
    w = ws - k + 1
    s_max = int(np.max(s_profile)) if s_profile.size else 0
    bound = r * r * w * w + 2 * r * w * s_max + int(
        np.dot(s_profile.astype(object), s_profile.astype(object))
    )
    if bound >= 2**63:
        raise OverflowError(
            f"scaled-integer scan would overflow int64 (bound {bound:.3g}); "
            "reduce the reference set size or window"
        )


def scan_window_distances_np_i64(
    codes: np.ndarray, s_profile: np.ndarray, k: int, ws: int, r: int
) -> np.ndarray:
    """Vectorised NumPy fallback of the native rolling scan (int64 exact).

    Uses the de-sequentialised match-count formulation of ops/scan.py
    (O(W)/bp as W passes of elementwise vector ops), not the O(nw * 4^k)
    brute-force oracle.
    """
    from .kmers import rolling_kmer_codes

    n = codes.shape[0]
    w = ws - k + 1
    nw = n - ws + 1
    kcodes = rolling_kmer_codes(codes, k)
    s64 = s_profile.astype(np.int64)
    g = s64[kcodes]

    counts0 = np.bincount(kcodes[:w], minlength=s_profile.shape[0]).astype(np.int64)
    diff0 = r * counts0 - s64
    d0 = np.dot(diff0, diff0)
    if nw == 1:
        return np.array([d0], dtype=np.int64)

    nt = nw - 1
    kl = kcodes[:nt]
    kr = kcodes[w : w + nt]
    ab = np.zeros(nt, dtype=np.int64)
    for d in range(1, w + 1):
        ab += kcodes[w - d : w - d + nt] == kr
        ab -= kcodes[d - 1 : d - 1 + nt] == kl
    delta = 2 * r * r * ((kl != kr).astype(np.int64) + ab) + 2 * r * (g[:nt] - g[w : w + nt])
    out = np.empty(nw, dtype=np.int64)
    out[0] = d0
    np.cumsum(delta, out=out[1:])
    out[1:] += d0
    return out


class HostScanEngine:
    """ScanEngine-compatible exact host engine (int64, native or NumPy)."""

    def __init__(self, s_profile: np.ndarray, k: int, ws: int, r: int):
        check_int64_headroom(s_profile, ws, k, r)
        self.s64 = np.ascontiguousarray(s_profile, dtype=np.int64)
        self.k, self.ws, self.r = k, ws, r
        self.scale = 2.0 * k * r * r
        self.bound_depth = None  # exact engine, no pruning pass

    def _thr_int(self, thr: float) -> np.int64:
        return np.int64(min(np.floor(thr * self.scale) + 2, 2**63 - 1))

    def prepare_codes(self, codes: np.ndarray, max_ws: int | None = None):
        return None  # host engine scans from host memory directly

    def _dists(self, codes: np.ndarray) -> np.ndarray:
        from ..utils.native import scan_rolling_i64_native

        d = scan_rolling_i64_native(codes, self.s64, self.k, self.ws, self.r)
        if d is None:
            d = scan_window_distances_np_i64(codes, self.s64, self.k, self.ws, self.r)
        return d

    def record_stream(self, codes: np.ndarray, thr: float, collect_dists: bool = False, codes_dev=None, seg_tracker=None):
        # seg_tracker (mid-record segment resume) applies to the
        # single-device segmented pipeline only; this engine has no
        # segmented path, so checkpointing stays per-record here

        codes = np.asarray(codes, dtype=np.int8)
        nw = codes.shape[0] - self.ws + 1
        assert nw >= 1
        d = self._dists(codes)
        thr_int = self._thr_int(thr)
        below = d < thr_int
        mask = below.copy()
        mask[1:] |= below[:-1]
        mask[0] = False  # window 0 is dist0, not part of the iterative phase
        idx = np.nonzero(mask)[0]
        stream = list(zip(idx.tolist(), (d[idx] / self.scale).tolist()))
        dist0 = float(d[0]) / self.scale
        dists = d / self.scale if collect_dists else None
        return dist0, stream, dists
