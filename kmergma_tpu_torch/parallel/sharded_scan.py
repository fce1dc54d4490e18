"""The scan sharded over a device mesh (counterpart of
``kmergma_tpu.parallel.sharded_scan``): ``ShardedScanEngine`` and
``ShardedClusterScanEngine`` on the mesh's data axis, and the two-axis
step ``sharded_cluster_scan_step`` on both of its axes.

A record's window axis is cut into n_data contiguous shards of equal span,
``rspan``-aligned (the record's windows over the shards, rounded up): data
shard d owns windows [d span, (d + 1) span).  Its codes, with a ws - 1 halo,
cross to its device through a pinned staging buffer, and the one-device
bitmap pass runs there with its carry seeded from the shard's own first
window, so each shard's bitmap is a certified superset on its own (for one
profile K1, or K4 on the depth route: exact mode and depths past
``MAX_BITMAP_DEPTH``; for clusters K3, K5's split pass or K4 and K6, by
the shard's length and the set's depths).  Every shard's pass is queued
before any is read back, so N cards run at once.  The shards' bitmaps come back to the
host, are all-gathered across processes as packed words, and one planned
pass then runs on the mesh's first device with its region rows cut from
the record's host codes (``ops/scan._planned_streams``): no device holds
the whole record.  Every process assembles the same streams, bit-identical
to the one-device engines'.

With a checkpoint's ``SegmentTracker`` a record of more than one segment
batch (n_data x ``_seg_spd`` spans of ``chunk`` windows) is scanned a batch
at a time, each shard owning ``_seg_spd`` spans of a batch, and each batch's
packed words are persisted: a killed scan resumes after the last batch
every shard finished.  The batch grid and the fingerprints are the JAX
engines'.

``sharded_cluster_scan_step`` shards m profiles over the mesh's "clusters"
axis, one block a row ("one expert per reference cluster"), and a record's
overlapped tiles (``make_tiles``) over its "data" axis: device (c, d)
computes the exact distances of tile block d against profile block c and
each tile's fixed-capacity candidate buffer, and the buffers are gathered
over both axes.  The tiles' match counts depend on the codes alone, so a
device counts them once through K2 (``ops/scan._rows_ab``) for all its
profiles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.reference import RefProfile
from ..ops.scan import (
    ScanEngine,
    _planned_streams,
    _rows_ab,
    _rows_d_from,
    _sq_norm,
    check_int32_headroom,
    fetch,
    fit_blocks,
    pack_bitmap_words,
    pad_to_device,
    profile_lookup,
    resume_segments,
    rolling_kmer_codes,
    unpack_bitmap_words,
)
from ..ops.scan_cluster import ClusterScanEngine
from ..ops.scan_cluster_fused import check_fits
from .mesh import Mesh, make_mesh


def _shard_span(nw: int, n_dev: int, rspan: int) -> int:
    """Windows each of ``n_dev`` shards owns in a one-pass scan of ``nw``
    windows: an equal share, rounded up to ``rspan`` (a whole number of
    bitmap blocks), so every shard but the last few has work."""
    return -(-(-(-nw // n_dev)) // rspan) * rspan


def _span_bucket(n: int) -> int:
    """Round span counts up to {1, 1.5} x a power of two (the JAX
    package's bucket, which fixes the spans per shard)."""
    b = 1
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b <<= 1
    return b


def _spans_per_shard(nw: int, span: int, n_dev: int) -> int:
    """Spans of ``span`` windows each shard scans for a record of ``nw``
    windows in one pass (the JAX engines' bucketed count)."""
    return _span_bucket(max(1, -(-(-(-nw // span)) // n_dev)))


def _shard_codes(codes: np.ndarray, shard: int, own: int, max_ws: int) -> np.ndarray:
    """Shard ``shard``'s contiguous codes: its ``own`` windows plus the
    ws - 1 halo (a view; the device copy zero-pads it).  The counterpart of
    the JAX ``_pack_region_rows``, without its 4-bases-a-byte packing."""
    lo = shard * own
    return codes[lo : lo + own + max_ws - 1]


def _all_gather(mesh: Mesh, local: torch.Tensor) -> list:
    """Every process's ``local`` (one shape in all of them), in process
    order: one all-gather over the process group (NCCL from the first card,
    gloo from the CPU)."""
    import torch.distributed as dist

    on = mesh.first if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = local.to(on).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.process_count)]
    if on.type == "cuda":
        with torch.cuda.device(on):  # this process's own card in the group
            dist.all_gather(parts, mine)
    else:
        dist.all_gather(parts, mine)
    return parts


def _all_gather_blocks(mesh: Mesh, local: np.ndarray) -> np.ndarray:
    """Every process's bool[..., n] block bitmap, joined in process order
    along the last axis: the packed words cross the process group once."""
    n = local.shape[-1]
    words = np.stack([pack_bitmap_words(row) for row in local.reshape(-1, n)])
    parts = _all_gather(mesh, torch.from_numpy(words.view(np.int32)))
    rows = [
        np.stack([unpack_bitmap_words(w, n) for w in p.cpu().numpy().view("<u4")]).reshape(local.shape)
        for p in parts
    ]
    return np.concatenate(rows, axis=-1)


def _fetch(pending: list, n_blocks: int, what: str, m: int | None = None) -> np.ndarray:
    """The shards' queued bitmaps, each read back and cut (or zero-padded)
    to its ``n_blocks`` blocks, joined along the last axis; a shard with no
    windows (None) is all zeros."""
    parts = []
    for item in pending:
        if item is None:
            shape = (n_blocks,) if m is None else (m, n_blocks)
            parts.append(np.zeros(shape, dtype=bool))
            continue
        bm, fits = item
        for fit in fits:  # one a K1 or K3 call: cluster mode makes one a group of 32 clusters
            check_fits(fit, what)
        host = fetch(bm)
        if m is None:
            parts.append(fit_blocks(host, n_blocks))
        else:
            parts.append(np.stack([fit_blocks(row, n_blocks) for row in host]))
    return np.concatenate(parts, axis=-1)


class ShardedScanEngine(ScanEngine):
    """``ScanEngine`` whose bitmap pass runs sharded over a mesh's data
    axis: the same (dist0, stream) contract, bit-identical to the
    one-device engine.  The planned pass, and ``collect_dists``, run on
    the mesh's first device.  Each shard's bitmap takes the one-device
    engine's route at ``bound_depth`` on its own card with its own copy of
    the profile: K1, or the depth route (K4) in exact mode
    (``bound_depth=None``) and past ``MAX_BITMAP_DEPTH``, each shard's
    codes padded for that route's kernel."""

    def takes_whole(self, n: int) -> bool:
        """Never: each shard's codes cross inside ``record_stream``."""
        return False

    #: spans per shard in one segment batch on the checkpointed path
    _seg_spd = 4

    def __init__(self, s_profile: np.ndarray, k: int, ws: int, r: int, mesh: Mesh | None = None, chunk_windows: int | None = None, *, bound_depth: int | None = 16, device: "str | torch.device" = "cuda"):
        mesh = make_mesh(device=device) if mesh is None else mesh
        super().__init__(s_profile, k, ws, r, device=mesh.first, bound_depth=bound_depth, chunk_windows=chunk_windows)
        self.mesh = mesh
        self._s_on = {self.device: self.s_dev}

    def _s(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._s_on:
            self._s_on[dev] = self.s_dev.to(dev)
        return self._s_on[dev]

    def record_stream(self, codes: "np.ndarray | torch.Tensor", thr: float, collect_dists: bool = False, codes_dev=None, seg_tracker=None):
        if collect_dists:  # whole-record distances stay on the first device
            return super().record_stream(codes, thr, collect_dists=True, codes_dev=codes_dev)
        codes = codes.cpu().numpy() if torch.is_tensor(codes) else codes
        codes = np.asarray(codes, dtype=np.int8)
        nw = codes.shape[0] - self.ws + 1
        if nw < 1:
            raise ValueError(f"record of {codes.shape[0]} bp is shorter than the windowsize {self.ws}")
        thr_int = int(self._thr_int(thr))
        flat = None
        if seg_tracker is not None:
            flat = self._segmented_sharded_bitmaps(codes, nw, thr_int, seg_tracker)
        if flat is None:
            flat = self._sharded_pass(codes, nw, _shard_span(nw, self.mesh.shape["data"], self.rspan), thr_int)
        n_blocks = -(-nw // self.rspan) * (self.rspan // self.block)
        flat_dev = torch.from_numpy(fit_blocks(flat, n_blocks)).to(self.device)
        dist0, stream = _planned_streams([self], codes, [flat_dev], [nw], [thr], [nw - 1])[0]
        return dist0, stream, None

    def _sharded_pass(self, codes: np.ndarray, nv: int, own: int, thr_int: int) -> np.ndarray:
        """One bitmap pass over the mesh: shard d scans windows
        [d own, (d + 1) own) of the window range starting at codes[0], ``nv``
        of which are valid.  Returns the flat bool bitmap of n_data x own /
        block blocks."""
        first = self.mesh.process_index * len(self.mesh.local_data)
        pending = []
        for j, dev in enumerate(self.mesh.local_data):
            lo = (first + j) * own
            nv_loc = min(max(nv - lo, 0), own)
            if nv_loc == 0:
                pending.append(None)
                continue
            part = _shard_codes(codes, first + j, own, self.ws)
            prep = pad_to_device(part, self._padded_len(part.shape[0]), self.codes_dtype, dev)
            fits: list = []
            bm = self._record_bitmap(prep, nv_loc, thr_int, s_dev=self._s(dev), fits_out=fits)
            pending.append((bm, fits))
        local = _fetch(pending, own // self.block, "fused_record_bitmaps")
        return _all_gather_blocks(self.mesh, local) if self.mesh.distributed else local

    def _segmented_sharded_bitmaps(self, codes: np.ndarray, nw: int, thr_int: int, tracker):
        """The checkpointed sharded pass: segment batches of n_data x
        ``_seg_spd`` spans, one mesh pass each, each batch's packed words
        persisted through ``tracker`` (the JAX format and ``sharded|...``
        fingerprint).  Returns None when the record fits one batch
        (per-record checkpointing is exact there)."""
        n_dev = self.mesh.shape["data"]
        spd = self._seg_spd
        if _spans_per_shard(nw, self.chunk, n_dev) <= spd:
            return None
        seg_windows = n_dev * spd * self.chunk
        blocks_per_seg = seg_windows // self.block
        fps = [
            f"sharded|{self.k}|{self.ws}|{self.r}|{self.chunk}|{self.block}|"
            f"{thr_int}|{self.bound_depth}|{fused}|{n_dev}|{spd}|{nw}"
            for fused in (False, True)
        ]
        start_seg, out, fp = resume_segments(tracker, fps, blocks_per_seg)
        for si in range(start_seg, -(-nw // seg_windows)):
            off = si * seg_windows
            flat = self._sharded_pass(codes[off:], min(nw - off, seg_windows), spd * self.chunk, thr_int)
            out.append(flat)
            tracker.done_segment(si, pack_bitmap_words(flat), fp)
        return np.concatenate(out)


class ShardedClusterScanEngine(ClusterScanEngine):
    """``ClusterScanEngine`` whose m-profile bitmap pass runs sharded over a
    mesh's data axis (profiles replicated on every shard's device), at
    ``bound_depth`` as the one-device engine.  Each shard takes the
    one-device routes on its own codes: K3 when the set has a
    ``shared_depth`` and the shard has at least ``fused_min_windows``
    windows, else the split pass (K5, or K4 and K6 for mixed depths and
    depths past ``MAX_BITMAP_DEPTH``).  K8 runs once per engine.  The
    streams, cut at the cluster loop's bound, are bit-identical to the
    one-device engine's."""

    def takes_whole(self, n: int) -> bool:
        """Never: each shard's codes cross inside ``record_streams``."""
        return False

    #: spans per shard in one segment batch on the checkpointed path
    _seg_spd = 4

    def __init__(self, profiles: list[RefProfile], k: int, mesh: Mesh | None = None, chunk_windows: int | None = None, *, bound_depth: int | None = 16, device: "str | torch.device" = "cuda"):
        mesh = make_mesh(device=device) if mesh is None else mesh
        super().__init__(profiles, k, device=mesh.first, chunk_windows=chunk_windows, bound_depth=bound_depth)
        self.mesh = mesh
        self._stacks = {self.device: self.s_stack}

    def _stack(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._stacks:
            self._stacks[dev] = self.s_stack.to(dev)
        return self._stacks[dev]

    def prepare_codes(self, codes):
        return None  # no device holds the whole record

    def _cluster_pass(self, codes: np.ndarray, n_valids: np.ndarray, thr_ints: np.ndarray, own: int) -> np.ndarray:
        """One m-cluster bitmap pass over the mesh: shard d scans windows
        [d own, (d + 1) own) of the range starting at codes[0]; ``n_valids``
        are the clusters' valid windows in it.  Returns bool[m, n_data x
        own / block]."""
        first = self.mesh.process_index * len(self.mesh.local_data)
        pending = []
        for j, dev in enumerate(self.mesh.local_data):
            lo = (first + j) * own
            nv_loc = np.clip(n_valids.astype(np.int64) - lo, 0, own)
            if nv_loc.max() == 0:
                pending.append(None)
                continue
            part = _shard_codes(codes, first + j, own, self.max_ws)
            prep = pad_to_device(part, self._padded_len(part.shape[0]), np.int8, dev)
            fits: list = []
            bm = self._bitmaps(prep, nv_loc.tolist(), thr_ints.tolist(), s_stack=self._stack(dev), fits_out=fits)
            pending.append((bm, fits))
        local = _fetch(pending, own // self.block, "fused_cluster_record_bitmaps", m=len(self.engines))
        return _all_gather_blocks(self.mesh, local) if self.mesh.distributed else local

    def _segmented_cluster_bitmaps(self, codes: np.ndarray, n_valids: np.ndarray, thr_ints: np.ndarray, tracker):
        """The checkpointed sharded cluster pass: segment batches of n_data
        x ``_seg_spd`` spans, each batch's m bitmaps' packed words persisted
        through ``tracker`` (the JAX ``shcluster|...`` fingerprint).
        Returns None when the record fits one batch."""
        n_dev = self.mesh.shape["data"]
        m = len(self.engines)
        nw_max = int(n_valids.max())
        spd = self._seg_spd
        if _spans_per_shard(nw_max, self.chunk, n_dev) <= spd:
            return None
        seg_windows = n_dev * spd * self.chunk
        blocks_per_seg = m * (seg_windows // self.block)
        fps = [
            f"shcluster|{self.k}|{tuple(e.ws for e in self.engines)}|"
            f"{tuple(e.r for e in self.engines)}|{self.chunk}|{self.block}|"
            f"{tuple(thr_ints.tolist())}|{self.groups[0][1]}|{fused}|"
            f"{n_dev}|{spd}|{nw_max}"
            for fused in (False, True)
        ]
        start_seg, restored, fp = resume_segments(tracker, fps, blocks_per_seg)
        out = [w.reshape(m, -1) for w in restored]
        for si in range(start_seg, -(-nw_max // seg_windows)):
            off = si * seg_windows
            nv_seg = np.clip(n_valids.astype(np.int64) - off, 0, seg_windows)
            bc = self._cluster_pass(codes[off:], nv_seg, thr_ints, spd * self.chunk)
            out.append(bc)
            tracker.done_segment(si, pack_bitmap_words(bc.reshape(-1)), fp)
        return np.concatenate(out, axis=1)

    def record_streams(self, codes: "np.ndarray | torch.Tensor", thrs: list[float], codes_dev=None, seg_tracker=None):
        if len(thrs) != len(self.engines):
            raise ValueError(f"{len(self.engines)} clusters but {len(thrs)} thresholds")
        codes = codes.cpu().numpy() if torch.is_tensor(codes) else codes
        codes = np.asarray(codes, dtype=np.int8)
        n = codes.shape[0]
        n_valids = np.array([n - e.ws + 1 for e in self.engines], dtype=np.int64)
        if (n_valids < 1).any():
            raise ValueError("record shorter than a cluster windowsize")
        thr_ints = np.array([e._thr_int(t) for e, t in zip(self.engines, thrs)], dtype=np.int32)
        bitmaps = None
        if seg_tracker is not None:
            bitmaps = self._segmented_cluster_bitmaps(codes, n_valids, thr_ints, seg_tracker)
        if bitmaps is None:
            own = _shard_span(int(n_valids.max()), self.mesh.shape["data"], self.engines[0].rspan)
            bitmaps = self._cluster_pass(codes, n_valids, thr_ints, own)
        rspan = self.engines[0].rspan
        flats = [
            torch.from_numpy(fit_blocks(bitmaps[ci], -(-int(nw) // rspan) * (rspan // self.block))).to(self.device)
            for ci, nw in enumerate(n_valids)
        ]
        # each stream stops at the cluster loop's bound, as the one-device
        # engine's does
        imax = n - self.max_ws - self.k + 2
        nws = [int(nw) for nw in n_valids]
        mis = [min(nw - 1, imax) for nw in nws]
        return _planned_streams(self.engines, codes, flats, nws, list(thrs), mis)


# ---------------------------------------------------------------------------
# The two-axis step: profiles over "clusters", genome tiles over "data"
# ---------------------------------------------------------------------------


def make_tiles(codes: np.ndarray, tile_windows: int, ws: int, n_tiles_round: int) -> tuple[np.ndarray, int]:
    """Cut one record into overlapped tiles of ``tile_windows`` windows each
    (halo ws - 1), zero-padded, with whole zero tiles up to a multiple of
    ``n_tiles_round`` for even sharding.

    Returns (tiles int8[n_tiles, tile_windows + ws - 1], n_real_windows)."""
    n = codes.shape[0]
    nw = n - ws + 1
    n_tiles = -(-nw // tile_windows)
    n_pad_tiles = -(-n_tiles // n_tiles_round) * n_tiles_round
    tile_len = tile_windows + ws - 1
    tiles = np.zeros((n_pad_tiles, tile_len), dtype=np.int8)
    for t in range(n_tiles):
        lo = t * tile_windows
        chunk = codes[lo : min(lo + tile_len, n)]
        tiles[t, : chunk.shape[0]] = chunk
    return tiles, nw


def _tile_candidates(d: torch.Tensor, thr, cap: int) -> tuple:
    """The candidates of each tile's distances d (int32[T, t]) under one
    threshold (counterpart of the JAX ``_tile_kernel`` after its distances):
    (d_first int32[T], count int32[T], idx int32[T, cap], vals int32[T,
    cap], below_first bool[T], below_last bool[T]).  A window is a
    candidate where it or the window before it lies below the threshold;
    idx holds the first min(cap, count) candidates in increasing order,
    then 0, and vals = d[idx]."""
    n, t = d.shape
    below = d < thr
    mask = below.clone()
    mask[:, 1:] |= below[:, :-1]
    # the JAX top_k of score t - p over the candidates: distinct scores,
    # so the order is the windows' whatever the tie rule
    score = torch.where(mask, t - torch.arange(t, dtype=torch.int32, device=d.device), 0)
    top = torch.topk(score, min(cap, t), dim=1).values
    idx = torch.where(top > 0, t - top, 0)
    if cap > t:
        idx = torch.nn.functional.pad(idx, (0, cap - t))
    vals = torch.gather(d, 1, idx.to(torch.int64))
    count = mask.sum(dim=1, dtype=torch.int32)
    return d[:, 0], count, idx.to(torch.int32), vals, below[:, 0], below[:, -1]


def sharded_cluster_scan_step(codes_tiles, s_profiles, thr_ints, *, k: int, ws: int, r: int, cap: int, mesh: Mesh) -> tuple:
    """The two-axis scan step (counterpart of the JAX
    ``sharded_cluster_scan_step``): profiles sharded over the mesh's
    "clusters" axis, the tiles over its "data" axis, each tile's
    candidates (``_tile_candidates``) gathered over both.

    codes_tiles: int8[T, t + ws - 1] (``make_tiles``); s_profiles:
    int32[m, 4^k]; thr_ints: int32[m] scaled thresholds; numpy arrays or
    tensors.  m must be a multiple of the clusters ways and T of the data
    ways.  Returns (d_first int32[m, T], count int32[m, T], idx int32[m, T,
    cap], vals int32[m, T, cap], below_first bool[m, T], below_last
    bool[m, T]) on the mesh's first device, the same in every process.
    Device (c, d) builds the K codes of tile block d once and counts their
    matches through K2 once, then looks up, sums and picks the candidates
    for each profile of block c; every device's work is queued before any
    result is read."""
    tiles = torch.as_tensor(codes_tiles).cpu()
    profiles = torch.as_tensor(s_profiles).cpu().to(torch.int32)
    thrs = torch.as_tensor(thr_ints).cpu().to(torch.int32)
    n_c, n_d = mesh.shape["clusters"], mesh.shape["data"]
    m, n_tiles = profiles.shape[0], tiles.shape[0]
    if m % n_c or thrs.shape[0] != m:
        raise ValueError(f"{m} profiles ({thrs.shape[0]} thresholds) do not split over {n_c} clusters ways")
    if n_tiles % n_d:
        raise ValueError(f"{n_tiles} tiles do not split over {n_d} data ways")
    t = tiles.shape[1] - ws + 1
    if t < 1:
        raise ValueError(f"tiles of {tiles.shape[1]} codes are shorter than the windowsize {ws}")
    for s in profiles.numpy():
        check_int32_headroom(s, ws, k, r)
    w = ws - k + 1
    m_loc, t_loc = m // n_c, n_tiles // n_d
    first = mesh.process_index * len(mesh.local_data)
    pending = []
    for c, row in enumerate(mesh.rows):
        block = []
        for j, dev in enumerate(row):
            lo = (first + j) * t_loc
            kc = rolling_kmer_codes(tiles[lo : lo + t_loc].to(dev), k)
            ab = _rows_ab(kc, w)
            outs = []
            for i in range(c * m_loc, (c + 1) * m_loc):
                s = profiles[i].to(dev)
                d = _rows_d_from(kc, profile_lookup(kc, s), _sq_norm(s), k, ws, r, ab=ab)
                outs.append(_tile_candidates(d, thrs[i].to(dev), cap))
            # one int32 block [m_loc, t_loc, 2 cap + 4] a device
            block.append(torch.stack([
                torch.cat([o[0][:, None], o[1][:, None], o[2], o[3], o[4][:, None].int(), o[5][:, None].int()], dim=1)
                for o in outs
            ]))
        pending.append(block)
    packed = torch.cat([torch.cat([b.to(mesh.first) for b in block], dim=1) for block in pending], dim=0)
    if mesh.distributed:  # the data axis runs across processes, processes outermost
        packed = torch.cat(_all_gather(mesh, packed), dim=1).to(mesh.first)
    return (packed[..., 0], packed[..., 1], packed[..., 2 : 2 + cap], packed[..., 2 + cap : 2 + 2 * cap],
            packed[..., 2 + 2 * cap].bool(), packed[..., 3 + 2 * cap].bool())
