"""K1, the fused lower-bound bitmap pass (counterpart of
``kmergma_tpu.ops.scan_fused.fused_record_bitmaps``), and its plain twin.

``fused_record_bitmaps`` launches the hand-written CUDA kernel of
``csrc/fused_cluster_bitmaps.cu`` on CUDA tensors and runs the plain
PyTorch twin on CPU tensors; any other device raises.  The bitmap is
any(scan_window_lower_bounds < thr) per ``block`` windows, masked to
p < nw, bit-identical on both routes.

Source note.  Replaces ``kmergma_tpu/ops/scan_fused.py::_fused_kernel``.
K1 is K3 (``scan_cluster_fused.fused_cluster_record_bitmaps``) at m = 1,
so it runs K3's kernel with one profile through K3's helpers: persistent
blocks that stage the 4^k table once (in shared memory when it fits,
else through ``__ldg``), codes by cp.async a tile ahead, the pair counts
tiled in registers and kept for pass 2, pass 1 telescoped, windows tiled
in registers in pass 2, and the int32 check of the tile bases only after
pass 2 is queued.  Bound by shared-memory instruction issue and the pair
counts' integer work, against one byte of codes read and 1/512 int32
written per window in device memory.  The TPU's sequential carry chain
stays two launches: tile totals, an exclusive scan of them here in torch,
then the bitmap from each tile's base.  The launches count on this
wrapper, not on K3's.
"""

from __future__ import annotations

import torch

from .scan import MAX_BITMAP_DEPTH, _k1_halo, _lower_bounds_from, profile_lookup, rolling_kmer_codes

_THREADS = 256  # the bitmap block's granularity: windows of one warp's round in K3's pass 2


def fused_record_bitmaps_plain(codes_dev: torch.Tensor, s_profile: torch.Tensor, *, thr: int, l0: torch.Tensor, nw: int, k: int, ws: int, r: int, depth: int, t: int, block: int, n_tiles: int) -> torch.Tensor:
    """The plain PyTorch twin of K1: the lower bounds of windows
    [0, n_tiles * t) from ``l0``, thresholded, masked to p < nw and
    reduced to one 0/1 per ``block`` windows.  int32[n_tiles, t // block]."""
    n_win = n_tiles * t
    w = ws - k + 1
    kcodes = rolling_kmer_codes(codes_dev[: n_win + ws - 1], k)
    g = profile_lookup(kcodes, s_profile)
    bounds = _lower_bounds_from(kcodes, g, l0, w, r, depth, n_win)
    pos = torch.arange(n_win, device=codes_dev.device)
    below = (bounds < thr) & (pos < nw)
    return below.view(n_tiles, t // block, block).any(dim=2).to(torch.int32)


def _k1_args(codes: torch.Tensor, s_profile: torch.Tensor, thr: int, nw: int, *, k: int, ws: int, r: int, depth: int, t: int, block: int, n_tiles: int) -> dict:
    """K3's launch arguments for one profile, counted on K1's wrapper."""
    from .scan_cluster_fused import _k3_args

    return _k3_args(
        codes, s_profile.view(1, -1), [int(thr)], [int(nw)],
        k=k, specs=[(ws, r)], depth=depth, t=t, block=block, n_tiles=n_tiles, wrapper=fused_record_bitmaps,
    )


def fused_record_bitmaps(codes_dev: torch.Tensor, s_profile: torch.Tensor, *, thr: int, l0: torch.Tensor, nw: int, k: int, ws: int, r: int, depth: int, t: int = 4096, block: int = 512, n_tiles: int, fits_out: list | None = None) -> torch.Tensor:
    """Whole-record fused bitmap pass.

    codes_dev: int8[>= n_tiles * t + halo] record codes (0..3), zero-padded;
    s_profile: int32[4^k]; thr: the conservative integer threshold;
    l0: 0-dim int32, the record's first-window lower bound at ``depth``
    (``scan._first_window_l0``); nw: the record's window count.
    Returns int32[n_tiles, t // block] activity flags.  ``fits_out``
    defers the int32 check of the tile bases to the caller, as K3's does
    (``scan_cluster_fused.check_fits``)."""
    w = ws - k + 1
    if codes_dev.dim() != 1 or codes_dev.dtype != torch.int8 or codes_dev.shape[0] < n_tiles * t + _k1_halo(w):
        raise ValueError(
            f"fused_record_bitmaps wants int8[>= {n_tiles * t + _k1_halo(w)}] codes, "
            f"got {codes_dev.dtype}{tuple(codes_dev.shape)}"
        )
    if s_profile.dtype != torch.int32 or s_profile.shape != (4**k,):
        raise ValueError(f"fused_record_bitmaps wants int32[{4**k}] S, got {s_profile.dtype}{tuple(s_profile.shape)}")
    if t % block or block % _THREADS or not 0 <= depth < w or depth > MAX_BITMAP_DEPTH:
        raise ValueError(
            f"fused_record_bitmaps: need t % block == 0, block % {_THREADS} == 0, 0 <= depth < w, "
            f"depth <= {MAX_BITMAP_DEPTH} (t={t}, block={block}, depth={depth}, w={w})"
        )
    kw = dict(k=k, ws=ws, r=r, depth=depth, t=t, block=block, n_tiles=n_tiles)
    if codes_dev.device.type == "cpu":
        return fused_record_bitmaps_plain(codes_dev, s_profile, thr=thr, l0=l0, nw=nw, **kw)
    if codes_dev.device.type != "cuda":
        raise ValueError(f"fused_record_bitmaps: unsupported device {codes_dev.device}")
    if not (codes_dev.is_contiguous() and s_profile.is_contiguous() and s_profile.device == codes_dev.device):
        raise ValueError("fused_record_bitmaps: codes and S must be contiguous on one device")
    from .scan_cluster_fused import _k3_run

    return _k3_run(_k1_args(codes_dev, s_profile, thr, nw, **kw), l0.view(1), fits_out).view(n_tiles, t // block)


#: K1 launches (two per call: totals, then bitmap) since the count was
#: last set to 0
fused_record_bitmaps.launches = 0
