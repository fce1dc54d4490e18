"""K1, the fused lower-bound bitmap pass (counterpart of
``kmergma_tpu.ops.scan_fused.fused_record_bitmaps``), and its plain twin.

``fused_record_bitmaps`` launches the hand-written CUDA kernel
``csrc/fused_bitmaps.cu`` on CUDA tensors and runs the plain PyTorch twin
on CPU tensors; any other device raises.  The bitmap is
any(scan_window_lower_bounds < thr) per ``block`` windows, masked to
p < nw, bit-identical on both routes.

Source note.  Replaces ``kmergma_tpu/ops/scan_fused.py::_fused_kernel``.
On the H100 it is bound by shared-memory reads: 2 * depth + 2 reads of K
and two table reads per window (34 + 2 at depth 16), against one byte of
codes read and 1/512 int32 written per window in device memory.  K and the
4^k table live in shared memory (the table through ``__ldg`` when it does
not fit), neighbouring threads take neighbouring windows, and the TPU's
sequential carry chain becomes two passes of one kernel: tile totals, an
exclusive scan of them here in torch, then the bitmap from each tile's
base.
"""

from __future__ import annotations

import torch

from .scan import _k1_halo, _lower_bounds_from, profile_lookup, rolling_kmer_codes

_THREADS = 256  # CUDA threads per K1 block (csrc/fused_bitmaps.cu kThreads)


def fused_record_bitmaps_plain(codes: torch.Tensor, s_profile: torch.Tensor, thr: int, l0: torch.Tensor, nw: int, *, k: int, ws: int, r: int, depth: int, t: int, block: int, n_tiles: int) -> torch.Tensor:
    """The plain PyTorch twin of K1: the lower bounds of windows
    [0, n_tiles * t) from ``l0``, thresholded, masked to p < nw and
    reduced to one 0/1 per ``block`` windows.  int32[n_tiles, t // block]."""
    n_win = n_tiles * t
    w = ws - k + 1
    kcodes = rolling_kmer_codes(codes[: n_win + ws - 1], k)
    g = profile_lookup(kcodes, s_profile)
    bounds = _lower_bounds_from(kcodes, g, l0, w, r, depth, n_win)
    pos = torch.arange(n_win, device=codes.device)
    below = (bounds < thr) & (pos < nw)
    return below.view(n_tiles, t // block, block).any(dim=2).to(torch.int32)


def fused_record_bitmaps(codes: torch.Tensor, s_profile: torch.Tensor, thr: int, l0: torch.Tensor, nw: int, *, k: int, ws: int, r: int, depth: int, t: int = 4096, block: int = 512, n_tiles: int) -> torch.Tensor:
    """Whole-record fused bitmap pass.

    codes: int8[>= n_tiles * t + halo] record codes (0..3), zero-padded;
    s_profile: int32[4^k]; thr: the conservative integer threshold;
    l0: 0-dim int32, the record's first-window lower bound at ``depth``
    (``scan._first_window_l0``); nw: the record's window count.
    Returns int32[n_tiles, t // block] activity flags."""
    w = ws - k + 1
    if codes.dim() != 1 or codes.dtype != torch.int8 or codes.shape[0] < n_tiles * t + _k1_halo(w):
        raise ValueError(
            f"fused_record_bitmaps wants int8[>= {n_tiles * t + _k1_halo(w)}] codes, "
            f"got {codes.dtype}{tuple(codes.shape)}"
        )
    if s_profile.dtype != torch.int32 or s_profile.shape != (4**k,):
        raise ValueError(f"fused_record_bitmaps wants int32[{4**k}] S, got {s_profile.dtype}{tuple(s_profile.shape)}")
    if t % block or block % _THREADS or not 0 <= depth < w:
        raise ValueError(f"fused_record_bitmaps: need t % block == 0, block % {_THREADS} == 0, 0 <= depth < w (t={t}, block={block}, depth={depth}, w={w})")
    if codes.device.type == "cpu":
        return fused_record_bitmaps_plain(
            codes, s_profile, thr, l0, nw,
            k=k, ws=ws, r=r, depth=depth, t=t, block=block, n_tiles=n_tiles,
        )
    if codes.device.type != "cuda":
        raise ValueError(f"fused_record_bitmaps: unsupported device {codes.device}")
    if not (codes.is_contiguous() and s_profile.is_contiguous() and s_profile.device == codes.device):
        raise ValueError("fused_record_bitmaps: codes and S must be contiguous on one device")
    from .._kernels import check, load

    lib = load()
    dev = codes.device
    totals = torch.empty(n_tiles, dtype=torch.int64, device=dev)
    bitmap = torch.empty((n_tiles, t // block), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (codes.data_ptr(), s_profile.data_ptr(), 4**k, k, w, r, depth, t, block, n_tiles, int(thr), nw)
        check(lib.kmg_fused_bitmaps(*args, None, totals.data_ptr(), None, 0, stream), "fused_record_bitmaps pass 1")
        fused_record_bitmaps.launches += 1
        # tile bases: l0 + exclusive prefix sum of the tile totals, in
        # int64, then checked to fit int32 (the headroom guard bounds every
        # true lower bound, so this cannot fail on a guarded profile)
        bases64 = l0.to(torch.int64) + torch.cumsum(totals, 0) - totals
        if not bool(((bases64 >= -(2**31)) & (bases64 < 2**31)).all()):
            raise OverflowError("fused_record_bitmaps: a tile base overflows int32")
        bases = bases64.to(torch.int32)
        check(lib.kmg_fused_bitmaps(*args, bases.data_ptr(), None, bitmap.data_ptr(), 1, stream), "fused_record_bitmaps pass 2")
        fused_record_bitmaps.launches += 1
    return bitmap


#: K1 launches (two per call: totals, then bitmap) since the count was
#: last set to 0
fused_record_bitmaps.launches = 0
