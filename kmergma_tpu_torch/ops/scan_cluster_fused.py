"""K3, the fused multi-cluster bitmap pass (counterpart of
``kmergma_tpu.ops.scan_cluster_fused.fused_cluster_record_bitmaps``), K8,
the round trip of every table entry through K3's lookup (counterpart of
``pack_lookup_roundtrip``), and their plain twins.

Both wrappers launch hand-written CUDA kernels of
``csrc/fused_cluster_bitmaps.cu`` on CUDA tensors and run their plain
PyTorch twins on CPU tensors; any other device raises.  K3's bitmap is,
per cluster, exactly that cluster's K1 bitmap (``fused_record_bitmaps``
with its own table, threshold, first-window bound and window count),
cluster-major: int32[m, n_tiles * t // block].

Source note.  K3 replaces ``kmergma_tpu/ops/scan_cluster_fused.py::
_fused_cluster_kernel``: K1 for m profiles in one pass, bound by
shared-memory instruction issue; K1 (``scan_fused.fused_record_bitmaps``)
launches it at m = 1.  Persistent blocks stage the m tables once (in
shared memory when they fit beside the tile, m = 6 at k = 6, else read
through ``__ldg``) and walk the tiles.  Pass 1 computes each window's pair
counts once for every cluster (16 positions a lane, tiled in registers),
leaves them in a scratch buffer for pass 2 (2 bytes a window) and sums
each tile's deltas in telescoped form; pass 2 holds 8 consecutive windows
per thread in registers, one block barrier per two clusters and tile.  The
carry chain stays two launches with the tile bases scanned here in torch
(``_k3_run``).  K8 replaces the kernel of ``pack_lookup_roundtrip``, which certified the TPU's MXU one-hot
lookup per chip; here one block per cluster stages that cluster's slice as
K3 does and reads every entry back through K3's lookup, the check of K3's
table staging on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..utils import trace
from .scan import MAX_BITMAP_DEPTH, _k1_halo, profile_lookup_multi
from .scan_fused import _THREADS, fused_record_bitmaps_plain

#: clusters one K3 launch takes (the per-cluster scalars ride the launch)
MAX_CLUSTERS = 32


def fused_cluster_record_bitmaps_plain(codes_dev: torch.Tensor, s_stack: torch.Tensor, *, thrs, l0s: torch.Tensor, nws, k: int, specs, depth: int, t: int, block: int, n_tiles: int) -> torch.Tensor:
    """The plain PyTorch twin of K3: each cluster's K1 plain twin
    (``fused_record_bitmaps_plain``) with its own (S_c, thr_c, l0_c, nw_c,
    ws_c, r_c).  int32[m, n_tiles * t // block]."""
    return torch.stack([
        fused_record_bitmaps_plain(
            codes_dev, s_stack[c], thr=int(thrs[c]), l0=l0s[c], nw=int(nws[c]),
            k=k, ws=ws, r=r, depth=depth, t=t, block=block, n_tiles=n_tiles,
        ).reshape(-1)
        for c, (ws, r) in enumerate(specs)
    ])


def fused_cluster_record_bitmaps(codes_dev: torch.Tensor, s_stack: torch.Tensor, *, thrs, l0s: torch.Tensor, nws, k: int, specs, depth: int, t: int = 4096, block: int = 512, n_tiles: int, fits_out: list | None = None) -> torch.Tensor:
    """Whole-record fused bitmap pass for m cluster profiles.

    codes_dev: int8[>= n_tiles * t + halo] record codes (0..3), zero-padded;
    s_stack: int32[m, 4^k]; specs: (ws_c, r_c) per cluster; thrs: the
    conservative integer thresholds; l0s: int32[m], each cluster's
    first-window lower bound at ``depth``; nws: the window counts.
    Returns int32[m, n_tiles * t // block] activity flags.  With
    ``fits_out`` the call does not wait for the card: it appends the 0-dim
    bool that says whether every tile base fitted int32, and the caller
    must check it before using the bitmap (``check_fits``)."""
    m = len(specs)
    widths = [ws - k + 1 for ws, _r in specs]
    if codes_dev.dim() != 1 or codes_dev.dtype != torch.int8 or codes_dev.shape[0] < n_tiles * t + _k1_halo(max(widths)):
        raise ValueError(
            f"fused_cluster_record_bitmaps wants int8[>= {n_tiles * t + _k1_halo(max(widths))}] codes, "
            f"got {codes_dev.dtype}{tuple(codes_dev.shape)}"
        )
    if s_stack.dtype != torch.int32 or s_stack.shape != (m, 4**k) or not 1 <= m <= MAX_CLUSTERS:
        raise ValueError(
            f"fused_cluster_record_bitmaps wants int32[m, {4**k}] S with 1 <= m <= {MAX_CLUSTERS}, "
            f"got {s_stack.dtype}{tuple(s_stack.shape)} for {m} specs"
        )
    if len(thrs) != m or len(nws) != m or l0s.shape != (m,):
        raise ValueError(f"fused_cluster_record_bitmaps: {m} clusters need m thresholds, bounds and window counts")
    if t % block or block % _THREADS or not 0 <= depth < min(widths) or depth > MAX_BITMAP_DEPTH:
        raise ValueError(
            f"fused_cluster_record_bitmaps: need t % block == 0, block % {_THREADS} == 0, "
            f"0 <= depth < min(w), depth <= {MAX_BITMAP_DEPTH} (t={t}, block={block}, depth={depth}, w_min={min(widths)})"
        )
    kw = dict(k=k, specs=specs, depth=depth, t=t, block=block, n_tiles=n_tiles)
    if codes_dev.device.type == "cpu":
        return fused_cluster_record_bitmaps_plain(codes_dev, s_stack, thrs=thrs, l0s=l0s, nws=nws, **kw)
    if codes_dev.device.type != "cuda":
        raise ValueError(f"fused_cluster_record_bitmaps: unsupported device {codes_dev.device}")
    if not (codes_dev.is_contiguous() and s_stack.is_contiguous() and s_stack.device == codes_dev.device):
        raise ValueError("fused_cluster_record_bitmaps: codes and S must be contiguous on one device")
    return _k3_run(_k3_args(codes_dev, s_stack, thrs, nws, **kw), l0s, fits_out)


#: K3 launches (two per call: totals, then bitmap) since the count was
#: last set to 0
fused_cluster_record_bitmaps.launches = 0


def _on_device(dev: torch.device):
    """``torch.cuda.device(dev)``, or nothing when ``dev`` is current (asked
    of the runtime directly: the wrappers run once CUDA is initialised)."""
    return contextlib.nullcontext() if dev.index == torch._C._cuda_getDevice() else torch.cuda.device(dev)


def _raw_stream(dev: torch.device) -> int:
    """The current stream of ``dev`` as the pointer the C entry points take
    (without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream(dev).cuda_stream`` would)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _k3_args(codes: torch.Tensor, s_stack: torch.Tensor, thrs, nws, *, k: int, specs, depth: int, t: int, block: int, n_tiles: int, wrapper=None) -> dict:
    """What K3's two launches share: the device, shapes, the C arguments up
    to n_tiles, and the wrapper whose launch count they raise
    (``fused_cluster_record_bitmaps``, or ``fused_record_bitmaps`` for K1)."""
    from .._kernels import int_array

    m = len(specs)
    widths = [ws - k + 1 for ws, _r in specs]
    scalars = [int_array(v) for v in (widths, [r for _ws, r in specs], thrs, nws)]
    return dict(
        dev=codes.device, m=m, n_tiles=n_tiles, per_tile=t // block,
        wrapper=fused_cluster_record_bitmaps if wrapper is None else wrapper,
        count_bytes=_count_bytes(t, min(widths), max(widths)),
        c_args=(codes.data_ptr(), s_stack.data_ptr(), m, 4**k, k, *scalars, depth, t, block, n_tiles),
    )


@functools.lru_cache(maxsize=None)
def _count_bytes(t: int, w_min: int, w_max: int) -> int:
    """Bytes of pair counts K3's pass 1 leaves per tile for pass 2."""
    from .._kernels import load

    return load().kmg_cluster_count_bytes(t, w_min, w_max)


def _k3_launch(args: dict, bases, totals, bitmap, counts: torch.Tensor, emit: bool) -> None:
    """One K3 launch; the tensors a pass does not use are None."""
    from .._kernels import check, load

    ptrs = [None if x is None else x.data_ptr() for x in (bases, totals, bitmap, counts)]
    dev = args["dev"]
    with _on_device(dev):
        err = load().kmg_fused_cluster_bitmaps(*args["c_args"], *ptrs, int(emit), _raw_stream(dev))
    wrapper = args["wrapper"]
    check(err, f"{wrapper.__name__} pass {2 if emit else 1}")
    wrapper.launches += 1


def _k3_run(args: dict, l0s: torch.Tensor, fits_out: list | None = None) -> torch.Tensor:
    """K3's two launches and the tile bases between them, from the
    int32[m] first-window bounds: the int32[m, n_tiles * t // block]
    bitmap.  The bases' int32 check waits for the card, unless
    ``fits_out`` takes it for the caller to make later."""
    totals, counts = _k3_totals(args)
    bases, fits = _k3_tile_bases(totals, l0s)
    bitmap = _k3_bitmap(args, bases, counts)
    # checked after pass 2 is queued, so the host waits once, not between
    # the passes; a bitmap from wrapped bases is never returned
    if fits_out is not None:
        fits_out.append(fits)
    else:
        check_fits(fits, args["wrapper"].__name__)
    return bitmap


def check_fits(fits: torch.Tensor, what: str) -> None:
    """Raise unless K1's or K3's tile bases all fitted int32 (``fits``, a
    0-dim bool on the card, read here: the host waits for it in a ``fetch``
    span, utils/trace.py)."""
    with trace.span("fetch") as sp:
        sp.add(bytes=fits.element_size())
        fitted = bool(fits)
    if not fitted:
        raise OverflowError(f"{what}: a tile base overflows int32")


def _k3_totals(args: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's pass 1: the int64[m, n_tiles] tile totals, and the uint8 pair
    counts it leaves for pass 2 (``count_bytes`` per tile)."""
    totals = torch.empty((args["m"], args["n_tiles"]), dtype=torch.int64, device=args["dev"])
    counts = torch.empty(args["n_tiles"] * args["count_bytes"], dtype=torch.uint8, device=args["dev"])
    _k3_launch(args, None, totals, None, counts, emit=False)
    return totals, counts


def _k3_bitmap(args: dict, bases: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """K3's pass 2: the int32[m, n_tiles * t // block] bitmap from the
    int32[m, n_tiles] tile bases and pass 1's pair counts."""
    bitmap = torch.empty((args["m"], args["n_tiles"] * args["per_tile"]), dtype=torch.int32, device=args["dev"])
    _k3_launch(args, bases, None, bitmap, counts, emit=True)
    return bitmap


def _k3_tile_bases(totals: torch.Tensor, l0s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per cluster, K1's tile bases: l0_c plus an exclusive prefix sum of
    the tile totals, in int64, as int32 (wrapped), and a 0-dim bool on the
    device that says whether every base fits int32."""
    bases64 = torch.cumsum(totals, 1).sub_(totals).add_(l0s[:, None])
    bases = bases64.to(torch.int32)
    return bases, (bases == bases64).all()


def cluster_launch_shape(m: int, k: int, t: int, w_min: int, w_max: int, n_tiles: int, *, emit: bool = True) -> dict:
    """K3's launch on the current CUDA device for these shapes: its grid
    (persistent blocks, at most one per tile), threads per block, resident
    blocks per SM and the device's SM count, for pass 2 (``emit``) or
    pass 1."""
    from .._kernels import check, load

    shape = (ctypes.c_int * 4)()
    check(load().kmg_cluster_launch_shape(m, 4**k, t, w_min, w_max, n_tiles, int(emit), shape), "cluster_launch_shape")
    return dict(zip(("grid", "threads", "blocks_per_sm", "sms"), shape))


def cluster_tables_in_smem(m: int, k: int, t: int, w_min: int, w_max: int) -> bool:
    """Whether K3 (and K8) stage the m tables in shared memory on the
    current CUDA device for tiles of t windows and widths w_min..w_max
    (else they read them through ``__ldg``)."""
    from .._kernels import check, load

    got = load().kmg_cluster_tables_in_smem(m, 4**k, t, w_min, w_max)
    if got < 0:
        check(-got, "cluster_tables_in_smem")
    return bool(got)


def _lookup_roundtrip_plain(s_stack: torch.Tensor) -> torch.Tensor:
    """The plain twin of K8: every S_c[v] through ``profile_lookup_multi``."""
    return profile_lookup_multi(torch.arange(s_stack.shape[1], device=s_stack.device), s_stack)


def lookup_roundtrip(s_stack: torch.Tensor, *, t: int, w_min: int, w_max: int) -> torch.Tensor:
    """Every entry S_c[v] read back through K3's lookup, with the tables
    placed as K3 places them for tiles of t windows and window widths
    w_min..w_max.  int32[m, 4^k], equal to ``s_stack`` when K3's staging is
    right.  Launches K8 on a CUDA tensor, the plain twin on a CPU tensor."""
    m = s_stack.shape[0]
    if s_stack.dim() != 2 or s_stack.dtype != torch.int32 or not 1 <= m <= MAX_CLUSTERS:
        raise ValueError(f"lookup_roundtrip wants int32[m, 4^k] with 1 <= m <= {MAX_CLUSTERS}, got {s_stack.dtype}{tuple(s_stack.shape)}")
    dev = s_stack.device
    if dev.type == "cpu":
        return _lookup_roundtrip_plain(s_stack)
    if dev.type != "cuda":
        raise ValueError(f"lookup_roundtrip: unsupported device {dev}")
    from .._kernels import check, load

    s_stack = s_stack.contiguous()
    out = torch.empty_like(s_stack)
    with _on_device(dev):
        err = load().kmg_lookup_roundtrip(s_stack.data_ptr(), m, s_stack.shape[1], t, w_min, w_max, out.data_ptr(), _raw_stream(dev))
    check(err, "lookup_roundtrip")
    lookup_roundtrip.launches += 1
    return out


#: K8 launches since the count was last set to 0
lookup_roundtrip.launches = 0
