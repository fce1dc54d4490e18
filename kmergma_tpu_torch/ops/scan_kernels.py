"""K2, the full-depth match-count kernel (counterpart of
``kmergma_tpu.ops.scan_pallas.match_counts``), its plain twin, and the
whole-record distance scan built on it.

``match_counts`` launches the hand-written CUDA kernel
``csrc/match_counts.cu`` on CUDA tensors and runs the plain PyTorch twin on
CPU tensors; any other device raises.

Source note.  Replaces ``kmergma_tpu/ops/scan_pallas.py::_match_counts_kernel``.
On the H100 it is bound by shared-memory reads: 2w compares per position
(568 at ws = 289, k = 6) against one read of K and one write of AB in
device memory.  One block stages a row of t + w int32 K codes in shared
memory and neighbouring threads take neighbouring positions, so the reads
are free of bank conflicts; rows may overlap in memory (a row stride), so
the whole-record scan tiles K without a copy.
"""

from __future__ import annotations

import torch

from .scan import _cumsum32, _first_window_d0, profile_lookup, rolling_kmer_codes


def _match_counts_plain(tiles_k: torch.Tensor, w: int, t: int) -> torch.Tensor:
    """AB[:, p] = sum_{d=1..w} [K[p+w-d] == K[p+w]] - [K[p+d-1] == K[p]]
    per row: the plain PyTorch twin of K2."""
    kl = tiles_k[:, :t]
    kr = tiles_k[:, w : w + t]
    a = torch.zeros(kl.shape, dtype=torch.int32, device=tiles_k.device)
    b = torch.zeros_like(a)
    for d in range(1, w + 1):
        a += tiles_k[:, w - d : w - d + t] == kr
        b += tiles_k[:, d - 1 : d - 1 + t] == kl
    return a - b


def match_counts(tiles_k: torch.Tensor, w: int, t: int) -> torch.Tensor:
    """Entering-minus-leaving window counts per transition, per row.

    tiles_k: int32[n, t + w] K codes; rows may be a strided view (row
    stride >= 1, unit column stride), e.g. ``unfold`` over a flat record.
    Returns int32[n, t].  Launches K2 on a CUDA tensor, the plain twin on
    a CPU tensor."""
    if tiles_k.dim() != 2 or tiles_k.shape[1] != t + w or tiles_k.dtype != torch.int32:
        raise ValueError(f"match_counts wants int32[n, t + w = {t + w}], got {tiles_k.dtype}{tuple(tiles_k.shape)}")
    if tiles_k.device.type == "cpu":
        return _match_counts_plain(tiles_k, w, t)
    if tiles_k.device.type != "cuda":
        raise ValueError(f"match_counts: unsupported device {tiles_k.device}")
    if tiles_k.stride(1) != 1:
        raise ValueError("match_counts: K codes need a unit column stride")
    from .._kernels import check, load

    lib = load()
    n = tiles_k.shape[0]
    out = torch.empty((n, t), dtype=torch.int32, device=tiles_k.device)
    if n == 0:
        return out
    with torch.cuda.device(tiles_k.device):
        stream = torch.cuda.current_stream(tiles_k.device).cuda_stream
        check(
            lib.kmg_match_counts(
                tiles_k.data_ptr(), tiles_k.stride(0), n, t, w, out.data_ptr(), stream
            ),
            "match_counts",
        )
    match_counts.launches += 1
    return out


#: K2 launches since the count was last set to 0
match_counts.launches = 0


def scan_window_distances_kernel(codes: torch.Tensor, s_profile: torch.Tensor, k: int, ws: int, r: int, tile_windows: int = 2048) -> torch.Tensor:
    """``scan_window_distances`` with the depth-W match counts from K2
    (counterpart of ``scan_window_distances_pallas``): the record's K codes
    are tiled by t = ``tile_windows`` transitions with a w halo, as a
    strided view without a copy.  Returns int32[n - ws + 1], bit-identical
    to ``scan.scan_window_distances``."""
    n = codes.shape[0]
    w = ws - k + 1
    nw = n - ws + 1
    t = tile_windows
    kcodes = rolling_kmer_codes(codes, k)
    g = profile_lookup(kcodes, s_profile)
    n_tiles = -(-nw // t)
    kcodes_pad = torch.nn.functional.pad(kcodes, (0, n_tiles * t + w - kcodes.shape[0]))
    tiles = kcodes_pad.unfold(0, t + w, t)  # tile i = K[i*t : i*t + t + w]
    ab = match_counts(tiles, w, t).reshape(-1)

    kl = kcodes[: nw - 1]
    kr = kcodes[w : w + nw - 1]
    r2 = 2 * r * r
    delta = r2 * (kl != kr).to(torch.int32) + r2 * ab[: nw - 1] + (2 * r) * (g[: nw - 1] - g[w : w + nw - 1])
    d0 = _first_window_d0(kcodes, s_profile, w, r)
    return torch.cat([d0.view(1), d0 + _cumsum32(delta)])
