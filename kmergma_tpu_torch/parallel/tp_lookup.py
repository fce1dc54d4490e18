"""Profile-axis sharding (counterpart of ``kmergma_tpu.parallel.tp_lookup``):
the 4^k spectrum table split over a mesh's devices, and ``TPScanEngine``,
the scan engine on it.

For large k the table grows as 4^k (4 MB of int32 at k = 10, 4.3 GB at
k = 15); this module shards the PROFILE axis: data shard j of a mesh of N
holds bins [j L, (j + 1) L) of the table (``shard_profile``), looks up the
K codes that fall in its range, g_part[i] = S_local[K[i] - j L] or 0, and
the partials are summed on the mesh's first device, then across processes
(``torch.distributed.all_reduce``: NCCL between cards, gloo between CPUs),
to g = S[K] (``tp_profile_lookup``).  The scan's only profile-indexed
quantities, g and ||S||^2, both reduce over bins, so the rest of the scan
runs unchanged on the first device: ``TPScanEngine``'s bitmap pass takes
its pair deltas from K6 (``scan_kernels.pair_ab_from_kcodes``) at the
bound depth (ws - k in exact mode), and its planned pass recomputes the
regions exactly through K2 (``scan._rows_d_from``).  K1 reads the whole
table, so this engine never runs it.  Streams equal the one-device
``ScanEngine``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.scan import (
    ScanEngine,
    _check_record_len,
    _lower_bound_base_from,
    _lower_bounds_from,
    _rows_d_from,
    rolling_kmer_codes,
)
from .mesh import Mesh, make_mesh


def shard_profile(s_profile: np.ndarray, mesh: Mesh) -> list:
    """This process's shards of an int32 profile over the mesh's data axis,
    one on each of its devices (``mesh.local_data``): the bin count padded
    with zeros up to a multiple of the axis size N, shard j of the axis
    holding bins [j L, (j + 1) L), L = padded bins / N."""
    n_dev = mesh.shape["data"]
    nbins = s_profile.shape[0]
    local = -(-nbins // n_dev)
    first = mesh.process_index * len(mesh.local_data)
    shards = []
    for j, dev in enumerate(mesh.local_data):
        part = np.zeros(local, dtype=np.int32)
        src = s_profile[(first + j) * local : (first + j + 1) * local]
        part[: src.shape[0]] = src
        shards.append(torch.as_tensor(part, device=dev))
    return shards


def _reduce(parts: list, mesh: Mesh) -> torch.Tensor:
    """The sum of this process's partial tensors on the mesh's first
    device, then over the process group (NCCL from the first card, gloo
    from the CPU)."""
    total = parts[0].to(mesh.first)
    for part in parts[1:]:
        total = total + part.to(mesh.first)
    if not mesh.distributed:
        return total
    import torch.distributed as dist

    on = mesh.first if dist.get_backend() == "nccl" else torch.device("cpu")
    buf = total.to(on).contiguous()
    if on.type == "cuda":
        with torch.cuda.device(on):  # this process's own card in the group
            dist.all_reduce(buf)
    else:
        dist.all_reduce(buf)
    return buf.to(mesh.first)


def tp_profile_lookup(kcodes: torch.Tensor, s_profile: list, *, mesh: Mesh) -> torch.Tensor:
    """g = S[K] with S sharded over the mesh's data axis: ``s_profile`` is
    this process's shards (``shard_profile``), each shard's masked partial
    lookup where(K - lo in range, S_local[clip(K - lo)], 0) on its device,
    summed (``_reduce``).  kcodes: int32 of any shape on the mesh's first
    device, the same in every process; returns int32 of that shape there."""
    local = s_profile[0].shape[0]
    first = mesh.process_index * len(mesh.local_data)
    parts = []
    for j, (s_local, dev) in enumerate(zip(s_profile, mesh.local_data)):
        idx = kcodes.to(dev) - (first + j) * local
        in_range = (idx >= 0) & (idx < local)
        parts.append(torch.where(in_range, s_local[idx.clamp(0, local - 1)], 0))
    return _reduce(parts, mesh)


def tp_sq_norm(shards: list, mesh: Mesh) -> torch.Tensor:
    """||S||^2 from the shards (0-dim int64 on the mesh's first device)."""
    return _reduce([(s.to(torch.int64) ** 2).sum().view(1) for s in shards], mesh)[0]


class TPScanEngine(ScanEngine):
    """``ScanEngine`` with the 4^k profile axis sharded over a mesh: each
    device of the mesh holds 1/N of the table, and the record's scan runs
    on the mesh's first device with every profile lookup reduced over the
    shards.  The bitmap pass takes certified lower bounds at
    ``bound_depth`` (16 by default, any depth below the window width; None
    = exact, depth ws - k) with K6's pair deltas, in spans of
    ``chunk_windows`` as the JAX engine; the planned pass recomputes the
    regions through K2.  The same (dist0, stream) contract as the
    one-device engine, with equal streams.  There is no segmented path and
    no cross-record prefetch (as in the JAX engine), so a checkpoint
    resumes this engine per record.

    No whole table lives on a device (``s_dev`` is None): the engine
    overrides every ``ScanEngine`` method that reads it (``_record_bitmap``,
    ``_rows_d``, ``_chunk_distances``), its ``record_stream`` never takes
    the segmented path, and ``_depth_bitmap`` raises."""

    def takes_whole(self, n: int) -> bool:
        """Never: the miners do not copy a record ahead for this engine."""
        return False

    def __init__(self, s_profile: np.ndarray, k: int, ws: int, r: int, mesh: Mesh | None = None, chunk_windows: int | None = None, bound_depth: int | None = 16, *, device: "str | torch.device" = "cuda"):
        self.mesh = make_mesh(device=device) if mesh is None else mesh
        # exact mode for the base class: its K1 depth limit does not apply
        super().__init__(s_profile, k, ws, r, device=self.mesh.first, bound_depth=None, chunk_windows=chunk_windows)
        self.bound_depth = None if bound_depth is None else min(bound_depth, ws - k)
        self.s2 = tp_sq_norm(self.shards, self.mesh)

    def _place_profile(self, s32: np.ndarray) -> None:
        self.shards = shard_profile(s32, self.mesh)
        return None

    @property
    def shard_bytes(self) -> int:
        """Bytes of the table each device of the mesh holds."""
        return self.shards[0].numel() * self.shards[0].element_size()

    def _spans(self, nw: int) -> tuple[int, int]:
        """(windows a span, spans) of the bitmap pass: spans of
        ``chunk_windows``, or one of the record's windows rounded up to the
        region grid when it is shorter."""
        span = min(self.chunk, -(-nw // self.rspan) * self.rspan)
        return span, -(-nw // span)

    def _padded_len(self, n: int) -> int:
        span, n_spans = self._spans(n - self.ws + 1)
        return max(n + self.rspan + 1, n_spans * span + self.ws - 1)

    def record_stream(self, codes: "np.ndarray | torch.Tensor", thr: float, collect_dists: bool = False, codes_dev: "torch.Tensor | None" = None, seg_tracker=None):
        """Scan one record; return (dist0, stream, dists_or_None), as
        ``ScanEngine.record_stream``.  ``seg_tracker`` is not read: this
        engine has no segmented path."""
        n = codes.shape[0]
        _check_record_len(n)
        nw = n - self.ws + 1
        if nw < 1:
            raise ValueError(f"record of {n} bp is shorter than the windowsize {self.ws}")
        prep = self.prepare_codes(codes) if codes_dev is None else codes_dev
        if collect_dists:
            return self._full_record(prep, nw, thr)
        dist0, stream = self._planned_record(prep, nw, thr)
        return dist0, stream, None

    def _record_bitmap(self, prep: torch.Tensor, nw: int, thr_int: int, s_dev=None, fits_out=None) -> torch.Tensor:
        """The record's block bitmap, a span at a time: each span's K
        codes, their sharded lookup, its first window's bound and K6's
        pair deltas give certified lower bounds (``_lower_bounds_from``),
        thresholded at ``thr_int``, masked to p < nw and reduced per block.
        ``s_dev`` and ``fits_out`` are not read.  Flat bool[n_spans * span
        / block]."""
        from ..ops.scan_kernels import pair_ab_from_kcodes

        k, ws, r = self.k, self.ws, self.r
        w = ws - k + 1
        depth = ws - k if self.bound_depth is None else self.bound_depth
        span, n_spans = self._spans(nw)
        nt = span - 1
        pos = torch.arange(span, device=prep.device)
        out = []
        for i in range(n_spans):
            start = i * span
            kc = rolling_kmer_codes(prep[start : start + span + ws - 1], k)
            g = tp_profile_lookup(kc, self.shards, mesh=self.mesh)
            l0 = _lower_bound_base_from(kc, g, self.s2, w, r, depth)
            bounds = _lower_bounds_from(kc, g, l0, w, r, depth, span, ab=pair_ab_from_kcodes(kc, w, nt, depth))
            below = (bounds < thr_int) & (pos < nw - start)
            out.append(below.view(-1, self.block).any(dim=1))
        return torch.cat(out)

    def _depth_bitmap(self, prep: torch.Tensor, nw: int, thr_int: int, depth: int, s_dev) -> torch.Tensor:
        raise NotImplementedError("TPScanEngine holds no whole table: every depth runs in _record_bitmap")

    def _rows_d(self, rows: torch.Tensor) -> torch.Tensor:
        kc = rolling_kmer_codes(rows, self.k)
        return _rows_d_from(kc, tp_profile_lookup(kc, self.shards, mesh=self.mesh), self.s2, self.k, self.ws, self.r)

    def _chunk_distances(self, codes: torch.Tensor) -> torch.Tensor:
        return self._rows_d(codes[None])[0]
